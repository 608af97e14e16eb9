"""Greedy peak extraction on the device.

Counterpart of lte_cell_scanner_tpu/ops/peak_jax.py and functionally
identical to the host search ops/peak.py::peak_search (reference:
src/searcher.cpp:422-510, Matlab/peak_search.m): after each extraction the
same PSS row is cleared within +/-274 lags, other rows there below -8 dB,
and everything below -12 dB. The loop is sequential by nature. On a card
it is one launch of the ``peak_greedy`` kernel (csrc/peak_greedy.cu): a
block a capture, its working rows in shared memory, each capture stopping
on the card at its first failed trip, so no trip waits on the host. The
plain version, a handful of vectorized tensor ops a trip on the (B, 3,
9600) tables of B captures, serves CPU tensors.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import HALF_FRAME, RX_CUTOFF
from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
from lte_cell_scanner_tpu_torch.kernels.build import check_launch, launcher
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.utils.device import launch_device, to_host
from lte_cell_scanner_tpu_torch.utils.dsp import chi2cdf_inv
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

MAX_PEAKS = 64  # table size of a first pass; real captures stay far below
# The most peaks the greedy loop can yield: peaks on one PSS row lie more
# than 2 * 137 lags apart on the 9600-lag circle (34 per row), so a loop of
# PEAK_BOUND trips is the unbounded search.
PEAK_BOUND = 3 * (HALF_FRAME // (2 * 137 + 1))
_DB8 = 10.0 ** (-8.0 / 10.0)
_DB12 = 10.0 ** (-12.0 / 10.0)


def r_th1_normalized(n_comb_xc: int, ds_comb_arm: int,
                     thresh1_n_nines: int = 12) -> float:
    """Scalar so that the device threshold is r_norm * sp_incoherent
    (src/CellSearch.cpp:500-503)."""
    dof = 2 * n_comb_xc * (2 * ds_comb_arm + 1)
    r_th1 = chi2cdf_inv(1 - 10.0 ** (-thresh1_n_nines), dof)
    return float(r_th1 / RX_CUTOFF / 137 / 2 / n_comb_xc
                 / (2 * ds_comb_arm + 1))


def peak_search_plain(packed: torch.Tensor, single: torch.Tensor,
                      r_norm: float, ds_comb_arm: int,
                      max_peaks: int = MAX_PEAKS) -> torch.Tensor:
    """Plain PyTorch version of the ``peak_greedy`` kernel, on a stack:
    packed (B, 7, 9600), single (B, 3, 9600, n_f); returns (B, max_peaks,
    4). Each trip takes one argmax per capture; ties go to the first
    index. A capture that is done stays done: its later trips change
    nothing, so the loop runs all max_peaks trips and reads nothing back.
    """
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
    return out


def peak_search_device(packed: torch.Tensor, single: torch.Tensor,
                       r_norm: float, ds_comb_arm: int,
                       max_peaks: int = MAX_PEAKS) -> torch.Tensor:
    """Extract up to max_peaks peaks, of one capture or of a stack.

    packed (7, 9600) or (B, 7, 9600): rows 0-2 collapsed pow, 3-5
    collapsed frq, 6 sp_incoherent; single (3, 9600, n_f) or
    (B, 3, 9600, n_f). Returns (max_peaks, 4) or (B, max_peaks, 4) float32
    rows [pow, refined_ind, foi, n_id_2]; pow == 0 marks unused slots (a
    real peak always has pow > 0). A CPU tensor takes the plain version; a
    CUDA tensor launches the ``peak_greedy`` kernel once (packed
    contiguous float32, single float32 at any strides, the fold's view),
    which never waits for the card.
    """
    if packed.dim() == 2:
        return peak_search_device(packed[None], single[None], r_norm,
                                  ds_comb_arm, max_peaks)[0]
    if packed.device.type == "cpu":
        return peak_search_plain(packed, single, r_norm, ds_comb_arm,
                                 max_peaks)
    B = packed.shape[0]
    if packed.dtype != torch.float32 or single.dtype != torch.float32 \
            or tuple(packed.shape[1:]) != (7, HALF_FRAME) \
            or single.dim() != 4 \
            or tuple(single.shape[:3]) != (B, 3, HALF_FRAME) \
            or single.device != packed.device \
            or not packed.is_contiguous() or packed.data_ptr() % 16 \
            or not 0 <= ds_comb_arm < HALF_FRAME:
        raise ValueError(
            "peak_search_device: want contiguous f32 packed (B, 7, 9600) "
            "and f32 single (B, 3, 9600, n_f) on one device, got "
            f"{packed.dtype} {tuple(packed.shape)}, {single.dtype} "
            f"{tuple(single.shape)}")
    out = torch.empty((B, max_peaks, 4), dtype=torch.float32,
                      device=packed.device)
    with launch_device(packed.device):
        code = launcher("peak_greedy")(
            packed.data_ptr(), single.data_ptr(), B, *single.stride(),
            r_norm, ds_comb_arm, max_peaks, _DB8, _DB12, out.data_ptr(),
            torch.cuda.current_stream(packed.device).cuda_stream)
    check_launch("peak_greedy", code)
    LAUNCHES["peak_greedy"] += 1
    TRACER.count("peaks.kernel_launches")
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
