"""Cell-specific downlink reference signals (36.211 6.10.1).

reference: src/lte_lib.cpp:305-405 (rs_dl_calc / rs_dl_shift_calc / RS_DL).
All RS for 20 slots x {sym 0, sym 1, sym n_symb_dl-3} are precomputed at
once, with the per-port frequency shifts.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.constants import N_RB_MAXDL
from benchmark.reference.pn import lte_pn_batch


def rs_dl_shift(slot_num: int, sym_num: int, port_num: int, cp_type: str,
                n_id_cell: int) -> float:
    """Subcarrier shift (0..5) of the RS comb for one port/symbol.

    Returns NaN if this (port, symbol) combination carries no RS.
    reference: src/lte_lib.cpp:327-351.
    """
    n_symb_dl = 7 if cp_type == "normal" else 6
    v = float("nan")
    if port_num == 0 and sym_num == 0:
        v = 0
    elif port_num == 0 and sym_num == n_symb_dl - 3:
        v = 3
    elif port_num == 1 and sym_num == 0:
        v = 3
    elif port_num == 1 and sym_num == n_symb_dl - 3:
        v = 0
    elif port_num == 2 and sym_num == 1:
        v = 3 * (slot_num & 1)
    elif port_num == 3 and sym_num == 1:
        v = 3 + 3 * (slot_num & 1)
    return float(np.mod(v + n_id_cell, 6))


class RSDL:
    """Precomputed downlink RS table for one cell.

    ``get_rs(slot, sym)``   -> (2*n_rb_dl,) complex QPSK sequence
    ``get_shift(slot, sym, port)`` -> comb offset (float; NaN if no RS)
    """

    def __init__(self, n_id_cell: int, n_rb_dl: int = 6, cp_type: str = "normal"):
        self.n_id_cell = n_id_cell
        self.n_rb_dl = n_rb_dl
        self.cp_type = cp_type
        self.n_symb_dl = 7 if cp_type == "normal" else 6
        n_cp = 1 if cp_type == "normal" else 0

        # Batch-generate the PN sequences for all (slot, sym) pairs at once.
        slots = []
        syms = []
        for slot_num in range(20):
            for t in range(3):
                sym_num = (self.n_symb_dl - 3) if t == 2 else t
                slots.append(slot_num)
                syms.append(sym_num)
        c_inits = [
            (1 << 10) * (7 * (s + 1) + l + 1) * (2 * n_id_cell + 1)
            + 2 * n_id_cell + n_cp
            for s, l in zip(slots, syms)
        ]
        c = lte_pn_batch(np.asarray(c_inits, dtype=np.uint64), 4 * N_RB_MAXDL)
        r_l_ns = ((1 - 2 * c[:, 0::2].astype(np.float64))
                  + 1j * (1 - 2 * c[:, 1::2].astype(np.float64))) / np.sqrt(2.0)
        lo = N_RB_MAXDL - n_rb_dl
        r = r_l_ns[:, lo:lo + 2 * n_rb_dl]

        self._table = {}
        self._shift = np.full((20 * self.n_symb_dl, 4), np.nan)
        for (slot_num, sym_num, row) in zip(slots, syms, r):
            self._table[(slot_num, sym_num)] = row
            key = slot_num * self.n_symb_dl + sym_num
            if sym_num in (0, self.n_symb_dl - 3):
                self._shift[key, 0] = rs_dl_shift(slot_num, sym_num, 0, cp_type, n_id_cell)
                self._shift[key, 1] = rs_dl_shift(slot_num, sym_num, 1, cp_type, n_id_cell)
            else:
                self._shift[key, 2] = rs_dl_shift(slot_num, sym_num, 2, cp_type, n_id_cell)
                self._shift[key, 3] = rs_dl_shift(slot_num, sym_num, 3, cp_type, n_id_cell)

    def get_rs(self, slot_num: int, sym_num: int) -> np.ndarray:
        return self._table[(slot_num, sym_num)]

    def get_shift(self, slot_num: int, sym_num: int, port_num: int) -> float:
        return float(self._shift[slot_num * self.n_symb_dl + sym_num, port_num])
