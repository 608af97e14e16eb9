"""Greedy peak extraction on the device.

Counterpart of lte_cell_scanner_tpu/ops/peak_jax.py and functionally
identical to the host search ops/peak.py::peak_search (reference:
src/searcher.cpp:422-510, Matlab/peak_search.m): after each extraction the
same PSS row is cleared within +/-274 lags, other rows there below -8 dB,
and everything below -12 dB. The loop is sequential by nature; each trip
is a handful of vectorized tensor ops on the (B, 3, 9600) tables of B
captures (the JAX sweep maps the one-capture loop over its captures), and
the host reads the stop flag only every few trips, or never.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import HALF_FRAME, RX_CUTOFF
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.utils.device import to_host
from lte_cell_scanner_tpu_torch.utils.dsp import chi2cdf_inv

MAX_PEAKS = 64  # table size of a first pass; real captures stay far below
# The most peaks the greedy loop can yield: peaks on one PSS row lie more
# than 2 * 137 lags apart on the 9600-lag circle (34 per row), so a loop of
# PEAK_BOUND trips is the unbounded search.
PEAK_BOUND = 3 * (HALF_FRAME // (2 * 137 + 1))
_DB8 = 10.0 ** (-8.0 / 10.0)
_DB12 = 10.0 ** (-12.0 / 10.0)
_SYNC_EVERY = 8  # greedy trips between reads of the stop flag


def r_th1_normalized(n_comb_xc: int, ds_comb_arm: int,
                     thresh1_n_nines: int = 12) -> float:
    """Scalar so that the device threshold is r_norm * sp_incoherent
    (src/CellSearch.cpp:500-503)."""
    dof = 2 * n_comb_xc * (2 * ds_comb_arm + 1)
    r_th1 = chi2cdf_inv(1 - 10.0 ** (-thresh1_n_nines), dof)
    return float(r_th1 / RX_CUTOFF / 137 / 2 / n_comb_xc
                 / (2 * ds_comb_arm + 1))


def peak_search_device(packed: torch.Tensor, single: torch.Tensor,
                       r_norm: float, ds_comb_arm: int,
                       max_peaks: int = MAX_PEAKS,
                       early_exit: bool = True) -> torch.Tensor:
    """Extract up to max_peaks peaks, of one capture or of a stack.

    packed (7, 9600) or (B, 7, 9600): rows 0-2 collapsed pow, 3-5
    collapsed frq, 6 sp_incoherent; single (3, 9600, n_f) or
    (B, 3, 9600, n_f). Returns (max_peaks, 4) or (B, max_peaks, 4) float32
    rows [pow, refined_ind, foi, n_id_2]; pow == 0 marks unused slots (a
    real peak always has pow > 0). Each trip takes one argmax per capture;
    ties go to the first index. A capture that is done stays done: its
    later trips change nothing, so the fixed trip count gives the same
    tables. ``early_exit`` reads the stop flag on the host every
    ``_SYNC_EVERY`` trips and stops once every capture is done; without it
    the loop runs all max_peaks trips and never waits for the device (a
    pipelined sweep).
    """
    if packed.dim() == 2:
        return peak_search_device(packed[None], single[None], r_norm,
                                  ds_comb_arm, max_peaks, early_exit)[0]
    dev = packed.device
    B = packed.shape[0]
    working = packed[:, 0:3].to(torch.float32).clone()      # (B, 3, 9600)
    frq = packed[:, 3:6].to(torch.int64)
    z_th1 = (r_norm * packed[:, 6]).to(torch.float32)       # (B, 9600)
    bi = torch.arange(B, device=dev)
    lag_idx = torch.arange(HALF_FRAME, device=dev)
    row_idx = torch.arange(3, device=dev)[None, :, None]
    offs = torch.arange(-ds_comb_arm, ds_comb_arm + 1, device=dev)
    out = torch.zeros((B, max_peaks, 4), dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for trip in range(max_peaks):
        flat = torch.argmax(working.view(B, -1), dim=1)
        n2 = flat // HALF_FRAME
        ind = flat % HALF_FRAME
        peak_pow = working[bi, n2, ind]
        valid = ~done & (peak_pow >= z_th1[bi, ind]) & (peak_pow > 0.0)

        # Refine to the strongest single lag within +/-ds_comb_arm
        # (src/searcher.cpp:457-465).
        foi = frq[bi, n2, ind]
        tws = torch.remainder(ind[:, None] + offs, HALF_FRAME)  # (B, 2a+1)
        sv = single[bi[:, None], n2[:, None], tws, foi[:, None]]
        best_ind = tws[bi, torch.argmax(sv, dim=1)]
        rec = torch.stack([peak_pow, best_ind.to(torch.float32),
                           foi.to(torch.float32), n2.to(torch.float32)], 1)
        out[:, trip] = torch.where(valid[:, None], rec, out[:, trip])

        # Cancellation: +/-274 cyclic window.
        dist = torch.abs(torch.remainder(
            lag_idx - ind[:, None] + HALF_FRAME // 2, HALF_FRAME)
            - HALF_FRAME // 2)
        near = (dist <= 2 * 137)[:, None, :]                # (B, 1, 9600)
        same = row_idx == n2[:, None, None]                 # (B, 3, 1)
        pp = peak_pow[:, None, None]
        w = torch.where(near & same, 0.0, working)
        w = torch.where(near & ~same & (w < pp * _DB8), 0.0, w)
        w = torch.where(w < pp * _DB12, 0.0, w)
        working = torch.where(valid[:, None, None], w, working)
        done = ~valid
        if early_exit and (trip + 1) % _SYNC_EVERY == 0 \
                and bool(to_host(done.all())):
            break
    return out


def redo_full_tables(tables: np.ndarray, packed: torch.Tensor,
                     single: torch.Tensor, r_norm: float,
                     ds_comb_arm: int) -> List[np.ndarray]:
    """Each capture's peak table of a first pass: ``tables`` (B,
    max_peaks, 4), already on the host, over the (B, 7, 9600) and (B, 3,
    9600, n_f) scan tables ``packed`` and ``single`` on their device. A
    first pass may cut a dense capture short: a full table is redone on
    that device by the greedy loop at PEAK_BOUND trips, the unbounded
    search (reference peak loop src/CellSearch.cpp:471-569)."""
    out = list(tables)
    full = np.flatnonzero(tables[:, -1, 0] > 0.0)
    if len(full) and tables.shape[1] < PEAK_BOUND:
        idx = torch.from_numpy(full).to(packed.device)
        redo = to_host(peak_search_device(packed[idx], single[idx],
                                          r_norm, ds_comb_arm,
                                          max_peaks=PEAK_BOUND))
        for k, b in enumerate(full):
            out[b] = redo[k]
    return out


def peaks_to_cells(peaks: np.ndarray, f_search_set: np.ndarray,
                   fc_requested: float, fc_programmed: float,
                   fs_programmed: float = 1.92e6) -> List[Cell]:
    """Convert the device peak table to Cell records (host side)."""
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    cells: List[Cell] = []
    for row in np.asarray(peaks, dtype=np.float64):
        if row[0] <= 0.0:
            break
        cells.append(Cell(
            fc_requested=fc_requested,
            fc_programmed=fc_programmed,
            fs_programmed=fs_programmed,
            pss_pow=float(row[0]),
            ind=float(row[1]),
            freq=float(f_search_set[int(row[2])]),
            n_id_2=int(row[3]),
        ))
    return cells
