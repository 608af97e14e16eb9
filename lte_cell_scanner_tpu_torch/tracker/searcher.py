"""In-tracker cell searcher and the initial calibration pass.

reference: src/searcher_thread.cpp (low-priority search on a 19200*8-sample
capture with a single frequency hypothesis = current global FO) and
src/LTE-Tracker.cpp:565-741 (kalibrate). Both run the port's cell search
(search/cell_search.py) on the tracker's device.
"""

from __future__ import annotations

from typing import Iterator, List, Set

import numpy as np

from lte_cell_scanner_tpu_torch.constants import CAPLENGTH
from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.search.cell_search import (
    cell_search, generate_search_sets)
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState


def searcher_pass(capbuf: np.ndarray, state: GlobalState,
                  tracked_ids: Set[int], device=None) -> List[Cell]:
    """Full validation search with one frequency hypothesis (the global
    FO); cells already tracked are dropped."""
    cells = cell_search(capbuf, state.fc_requested, state.fc_programmed,
                        state.fs_programmed,
                        f_search_set=[state.frequency_offset], device=device)
    return [c for c in cells if c.n_id_cell() not in tracked_ids]


def kalibrate(sample_source: Iterator[np.ndarray], state: GlobalState,
              ppm: float = 120, max_blocks: int = 10000,
              correction: float = 1.0, device=None) -> float:
    """One-shot CellSearch over raw input until a cell decodes.

    Returns the freq_superfine of the strongest cell found.

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
                            device=device)
        if cells:
            best = max(cells, key=lambda c: c.pss_pow)
            return float(best.freq_superfine)
        if n_blocks > max_blocks:
            raise RuntimeError("kalibrate: no cell found in the input")
    raise RuntimeError("kalibrate: sample source exhausted before a cell "
                       "was found")
