"""In-tracker cell searcher and the initial calibration pass.

reference: src/searcher_thread.cpp (low-priority search on a 19200*8-sample
capture with a single frequency hypothesis = current global FO) and
src/LTE-Tracker.cpp:565-741 (kalibrate). With ``backend="torch"`` (the
default) both run the port's cell search (search/cell_search.py) on the
tracker's device; with ``backend="numpy"`` they run the float64 host
chain, the searcher candidate by candidate as the JAX package's does.
"""

from __future__ import annotations

from typing import Iterator, List, Set

import numpy as np

from lte_cell_scanner_tpu_torch.constants import (CAPLENGTH, DS_COMB_ARM,
                                                  THRESH2_N_SIGMA)
from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.models.rs import RSDL
from lte_cell_scanner_tpu_torch.ops.pbch import decode_mib
from lte_cell_scanner_tpu_torch.ops.peak import peak_search
from lte_cell_scanner_tpu_torch.ops.sync import pss_sss_foe, sss_detect
from lte_cell_scanner_tpu_torch.ops.tfg import extract_tfg, tfoec
from lte_cell_scanner_tpu_torch.ops.xcorr import xcorr_pss
from lte_cell_scanner_tpu_torch.search.cell_search import (
    cell_search, detection_threshold, generate_search_sets)
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState


def searcher_pass(capbuf: np.ndarray, state: GlobalState,
                  tracked_ids: Set[int], device=None,
                  backend: str = "torch") -> List[Cell]:
    """Full validation search with one frequency hypothesis (the global
    FO); cells already tracked are left out.

    ``backend="torch"`` runs the device cell search on ``device`` (a MIB
    decode of every candidate) and drops tracked IDs afterwards;
    ``backend="numpy"`` runs the float64 host chain, which skips a
    tracked ID before its MIB and a candidate whose grid does not fit in
    the capture."""
    if backend == "torch":
        cells = cell_search(capbuf, state.fc_requested, state.fc_programmed,
                            state.fs_programmed,
                            f_search_set=[state.frequency_offset],
                            device=device)
        return [c for c in cells if c.n_id_cell() not in tracked_ids]
    if backend != "numpy":
        raise ValueError(f"backend must be 'torch' or 'numpy', not "
                         f"{backend!r}")
    f_search_set = np.array([state.frequency_offset])
    fc_req = state.fc_requested
    fc_prog = state.fc_programmed
    fs_prog = state.fs_programmed

    r = xcorr_pss(capbuf, f_search_set, DS_COMB_ARM, fc_req, fc_prog,
                  fs_prog)
    z_th1 = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    peaks = peak_search(r.xc_incoherent_collapsed_pow,
                        r.xc_incoherent_collapsed_frq, z_th1, f_search_set,
                        fc_req, fc_prog, r.xc_incoherent_single, DS_COMB_ARM,
                        fs_prog)
    found: List[Cell] = []
    for cell in peaks:
        cell = sss_detect(cell, capbuf, THRESH2_N_SIGMA, fc_req, fc_prog,
                          fs_prog)
        if cell.n_id_1 < 0:
            continue
        if cell.n_id_cell() in tracked_ids:
            continue
        cell = pss_sss_foe(cell, capbuf, fc_req, fc_prog, fs_prog)
        try:
            tfg, ts = extract_tfg(cell, capbuf, fc_req, fc_prog, fs_prog)
        except ValueError:
            continue  # capture too short for a full TFG
        rs_dl = RSDL(cell.n_id_cell(), 6, cell.cp_type)
        cell, tfg_comp, _ = tfoec(cell, tfg, ts, fc_req, fc_prog, rs_dl)
        cell = decode_mib(cell, tfg_comp, rs_dl)
        if cell.n_rb_dl < 0:
            continue
        found.append(cell)
    return found


def kalibrate(sample_source: Iterator[np.ndarray], state: GlobalState,
              ppm: float = 120, max_blocks: int = 10000,
              correction: float = 1.0, device=None,
              backend: str = "torch") -> float:
    """One-shot CellSearch over raw input until a cell decodes.

    Returns the freq_superfine of the strongest cell found. ``backend``
    and ``device`` are those of :func:`cell_search`.

    ``correction`` is the crystal correction factor from a previous
    CellSearch run: the hypothesis grid is offset by
    ``fc*correction - fc`` so a pre-calibrated crystal's true offset
    sits at the center of the hunt even when it exceeds ``ppm``
    (reference: src/LTE-Tracker.cpp:586).
    """
    _, f_search_set = generate_search_sets(state.fc_requested,
                                           state.fc_requested, ppm)
    f_search_set = np.asarray(f_search_set, dtype=float) \
        + (state.fc_requested * correction - state.fc_requested)
    buf = np.zeros(0, dtype=complex)
    n_blocks = 0
    for raw in sample_source:
        buf = np.concatenate([buf, bytes_to_iq(raw)])
        n_blocks += 1
        if len(buf) < CAPLENGTH:
            if n_blocks > max_blocks:
                raise RuntimeError("kalibrate: no cell found in the input")
            continue
        capbuf = buf[:CAPLENGTH]
        buf = buf[CAPLENGTH:]   # keep the remainder for the next attempt
        cells = cell_search(capbuf, state.fc_requested, state.fc_programmed,
                            state.fs_programmed, f_search_set=f_search_set,
                            device=device, backend=backend)
        if cells:
            best = max(cells, key=lambda c: c.pss_pow)
            return float(best.freq_superfine)
        if n_blocks > max_blocks:
            raise RuntimeError("kalibrate: no cell found in the input")
    raise RuntimeError("kalibrate: sample source exhausted before a cell "
                       "was found")
