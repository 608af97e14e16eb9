"""Downlink eNodeB signal simulator — the "fake base station" backend.

reference: Matlab/create_dl_sig.m (RS + PSS/SSS + random traffic at a load
factor). Extended beyond the reference with a real PBCH so the full
pipeline — including blind MIB decode — closes the loop in simulation
(the reference's simulator carries no PBCH; its Monte-Carlo harness
Matlab/pss_search_final.m measures sync-stage statistics only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from benchmark.reference.constants import FS_SEARCH
from benchmark.reference.convcode import lte_conv_encode
from benchmark.reference.crc import lte_calc_crc
from benchmark.reference.modulation import lte_modulate
from benchmark.reference.pn import lte_pn
from benchmark.reference.pss import pss_fd
from benchmark.reference.ratematch import lte_conv_ratematch
from benchmark.reference.rs import RSDL
from benchmark.reference.sss import sss_fd
from benchmark.reference.dsp import idft

N_DFT = 128
N_SC = 72  # 6 RB

_BW_TO_CODE = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
_PHICH_RES_TO_CODE = {1 / 6: 0, 1 / 2: 1, 1.0: 2, 2.0: 3}


@dataclasses.dataclass
class MibConfig:
    n_rb_dl: int = 50
    phich_duration: str = "normal"  # or "extended"
    phich_resource: float = 1.0     # 1/6, 1/2, 1, 2
    sfn_start: int = 0              # SFN of the first generated frame


def encode_pbch(mib: MibConfig, n_id_cell: int, cp_type: str) -> np.ndarray:
    """QPSK symbols of one 40 ms PBCH period (m_bit/2 symbols).

    36.212 5.3.1 chain for 1-port transmission: MIB pack -> CRC16
    (no mask) -> tail-biting conv encode -> rate match -> scramble ->
    QPSK.
    """
    m_bit = 1920 if cp_type == "normal" else 1728
    bits = np.zeros(24, dtype=np.uint8)
    bw = _BW_TO_CODE[mib.n_rb_dl]
    bits[0], bits[1], bits[2] = (bw >> 2) & 1, (bw >> 1) & 1, bw & 1
    bits[3] = 1 if mib.phich_duration == "extended" else 0
    res = _PHICH_RES_TO_CODE[mib.phich_resource]
    bits[4], bits[5] = (res >> 1) & 1, res & 1
    sfn_high = (mib.sfn_start >> 2) & 0xFF
    for i in range(8):
        bits[6 + i] = (sfn_high >> (7 - i)) & 1
    c = np.concatenate([bits, lte_calc_crc(bits, "crc16")])
    d = lte_conv_encode(c)
    e = lte_conv_ratematch(d.astype(np.float64), m_bit).astype(np.uint8)
    scr = lte_pn(n_id_cell, m_bit)
    return lte_modulate(e ^ scr, "qpsk")


def build_grid(cp_type: str, n_subframes: int, slot_start: int,
               n_id_1: int, n_id_2: int, load_factor: float,
               rng: Optional[np.random.Generator] = None,
               mib: Optional[MibConfig] = None) -> np.ndarray:
    """Resource-element grid (n_ofdm_total, 72): RS, sync, traffic, PBCH.

    Column c is subcarrier c-36 relative to DC for c >= 36, c-36 for
    c < 36 (DC itself excluded) — the same layout extract_tfg produces.
    """
    rng = rng if rng is not None else np.random.default_rng()
    n_ofdm = 7 if cp_type == "normal" else 6
    n_id_cell = n_id_2 + 3 * n_id_1
    rs_dl = RSDL(n_id_cell, 6, cp_type)
    v_shift_m3 = n_id_cell % 3

    n_slots = 2 * n_subframes
    grid = np.zeros((n_slots * n_ofdm, N_SC), dtype=complex)

    # One PBCH encoding per 40 ms block (the SFN high bits change every 4
    # frames, so each block is re-encoded).
    pbch_cache = {}

    def pbch_block(sfn_base):
        if sfn_base not in pbch_cache:
            cfg = dataclasses.replace(mib, sfn_start=sfn_base % 1024)
            pbch_cache[sfn_base] = encode_pbch(cfg, n_id_cell, cp_type)
        return pbch_cache[sfn_base]

    # Track the SFN across generated slots: the frame containing the first
    # generated slot has SFN mib.sfn_start.
    sfn = mib.sfn_start if mib is not None else 0

    for t in range(n_slots):
        slot_num = (slot_start + t) % 20
        if t > 0 and slot_num == 0:
            sfn += 1
        for k in range(n_ofdm):
            row = t * n_ofdm + k
            syms = np.zeros(N_SC, dtype=complex)
            rs_ind = np.array([], dtype=int)
            if k in (0, n_ofdm - 3):
                s0 = int(rs_dl.get_shift(slot_num, k, 0))
                s1 = int(rs_dl.get_shift(slot_num, k, 1))
                rs_ind = np.concatenate([np.arange(s0, N_SC, 6),
                                         np.arange(s1, N_SC, 6)])
                p = rs_dl.get_rs(slot_num, k)
                syms[np.arange(s0, N_SC, 6)] = p
                syms[np.arange(s1, N_SC, 6)] = p

            # PBCH: slot 1, symbols 0..3, segment sfn % 4.
            on_pbch = mib is not None and slot_num == 1 and k <= 3
            if on_pbch:
                seg = sfn % 4
                pbch_syms = pbch_block(sfn - seg)
                n_per_frame = len(pbch_syms) // 4
                rs_here = k in (0, 1) or (k == 3 and n_ofdm == 6)
                sc = np.arange(N_SC)
                mask = ~((sc % 3 == v_shift_m3) & rs_here)
                # symbols 0..3 carry n_per_frame REs in row-major order
                counts = []
                for kk in range(4):
                    rh = kk in (0, 1) or (kk == 3 and n_ofdm == 6)
                    counts.append(N_SC - 24 if rh else N_SC)
                off = seg * n_per_frame + sum(counts[:k])
                syms[mask] = pbch_syms[off:off + mask.sum()]

            # Random traffic on free REs.
            occupied = set(rs_ind.tolist())
            if on_pbch:
                occupied |= set(np.arange(N_SC).tolist())  # PBCH fills row
            free = np.array(sorted(set(range(N_SC)) - occupied), dtype=int)
            n_data = round(len(free) * load_factor)
            if n_data:
                pick = rng.permutation(len(free))[:n_data]
                bits = rng.integers(0, 2, 2 * n_data)
                syms[free[pick]] = lte_modulate(bits, "qpsk")

            # Sync: PSS on the last, SSS on the second-to-last symbol of
            # slots 0 and 10; outer 5 SC on each side are guards.
            if slot_num % 10 == 0 and k >= n_ofdm - 2:
                ow = (pss_fd(n_id_2) if k == n_ofdm - 1
                      else sss_fd(n_id_1, n_id_2, slot_num).astype(complex))
                syms = np.zeros(N_SC, dtype=complex)
                syms[5:36] = ow[:31]
                syms[36:67] = ow[31:]

            grid[row] = syms
    return grid


def grid_to_time(grid: np.ndarray, cp_type: str) -> np.ndarray:
    """OFDM-modulate a grid: 128-point IDFT per symbol + cyclic prefixes."""
    n_ofdm = 7 if cp_type == "normal" else 6
    n_rows = grid.shape[0]
    idft_in = np.zeros((n_rows, N_DFT), dtype=complex)
    idft_in[:, 1:1 + N_SC // 2] = grid[:, N_SC // 2:]
    idft_in[:, -N_SC // 2:] = grid[:, :N_SC // 2]
    td = idft(idft_in, axis=-1)
    out = []
    for r in range(n_rows):
        k = r % n_ofdm
        if cp_type == "extended":
            cp = 32
        else:
            cp = 10 if k == 0 else 9
        out.append(np.concatenate([td[r, -cp:], td[r]]))
    return np.concatenate(out)


def create_dl_sig(cp_type: str, n_subframes: int, slot_start: int,
                  n_id_1: int, n_id_2: int, load_factor: float,
                  rng: Optional[np.random.Generator] = None,
                  mib: Optional[MibConfig] = None) -> np.ndarray:
    """Time-domain DL signal of n_subframes ms at 1.92 Msps."""
    grid = build_grid(cp_type, n_subframes, slot_start, n_id_1, n_id_2,
                      load_factor, rng, mib)
    sig = grid_to_time(grid, cp_type)
    assert len(sig) == round(n_subframes * 0.001 * FS_SEARCH)
    return sig


def apply_channel(sig: np.ndarray, snr_db: Optional[float] = None,
                  freq_offset: float = 0.0, delay: int = 0,
                  taps: Optional[Sequence[complex]] = None,
                  fs: float = FS_SEARCH,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Impair a transmitted signal: multipath, delay, frequency offset, AWGN."""
    rng = rng if rng is not None else np.random.default_rng()
    x = np.asarray(sig, dtype=complex)
    if taps is not None:
        x = np.convolve(x, np.asarray(taps, dtype=complex))[:len(x)]
    if delay:
        x = np.concatenate([np.zeros(delay, dtype=complex), x])
    if freq_offset:
        t = np.arange(len(x))
        x = x * np.exp(1j * 2 * np.pi * freq_offset * t / fs)
    if snr_db is not None:
        nz = np.abs(x) > 0
        sig_pow = np.mean(np.abs(x[nz]) ** 2) if nz.any() else 1.0
        np_pow = sig_pow / 10 ** (snr_db / 10)
        x = x + (rng.standard_normal(len(x))
                 + 1j * rng.standard_normal(len(x))) * np.sqrt(np_pow / 2)
    return x


def synthetic_capture(n_id_1: int = 90, n_id_2: int = 1,
                      cp_type: str = "normal", snr_db: float = 10.0,
                      freq_offset: float = 7.7e3, n_subframes: int = 80,
                      load_factor: float = 0.5, slot_start: int = 0,
                      n_rb_dl: int = 50, sfn_start: int = 100,
                      seed: int = 0) -> np.ndarray:
    """An 80 ms capture of a simulated cell (with PBCH) through a channel."""
    rng = np.random.default_rng(seed)
    mib = MibConfig(n_rb_dl=n_rb_dl, sfn_start=sfn_start)
    tx = create_dl_sig(cp_type, n_subframes, slot_start, n_id_1, n_id_2,
                       load_factor, rng, mib=mib)
    return apply_channel(tx, snr_db=snr_db, freq_offset=freq_offset, rng=rng)
