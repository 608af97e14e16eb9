"""Cell search on one capture: scan -> greedy peaks -> SSS/FOE -> blind MIB.

Counterpart of lte_cell_scanner_tpu/search/cell_search.py (reference:
src/CellSearch.cpp:437-618), with two backends:

- ``backend="torch"`` (the default): the scan, the symbol demodulation
  and the Viterbi decoder run as hand-written CUDA kernels on the card;
  the rest is PyTorch on the same device, with the float64 index planning
  on the host.
- ``backend="numpy"``: the float64 host chain, candidate by candidate
  (xcorr_pss -> threshold -> peak_search, then sss_detect -> pss_sss_foe
  -> extract_tfg -> tfoec -> decode_mib), the JAX package's default.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import (DS_COMB_ARM, RX_CUTOFF,
                                                  THRESH1_N_NINES,
                                                  THRESH2_N_SIGMA)
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.models.rs import RSDL
from lte_cell_scanner_tpu_torch.ops import peak as host_peak
from lte_cell_scanner_tpu_torch.ops.mib_torch import decode_mib_batch
from lte_cell_scanner_tpu_torch.ops.pbch import decode_mib
from lte_cell_scanner_tpu_torch.ops.peak_torch import (MAX_PEAKS,
                                                       peak_search_device,
                                                       peaks_to_cells,
                                                       r_th1_normalized,
                                                       redo_full_tables)
from lte_cell_scanner_tpu_torch.ops.sync import pss_sss_foe, sss_detect
from lte_cell_scanner_tpu_torch.ops.sync_torch import sss_foe_batch
from lte_cell_scanner_tpu_torch.ops.tfg import extract_tfg, tfoec
from lte_cell_scanner_tpu_torch.ops.xcorr import xcorr_pss
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import scan_plan, xcorr_core
from lte_cell_scanner_tpu_torch.utils.device import (full_f32_matmuls,
                                                     resolve_device, to_host)
from lte_cell_scanner_tpu_torch.utils.dsp import chi2cdf_inv, matlab_range
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER


def generate_search_sets(freq_start: float, freq_end: float, ppm: float):
    """Center-frequency sweep (100 kHz raster) and per-fc offset grid
    (reference: src/CellSearch.cpp:463-465)."""
    n_extra = int(np.floor((freq_start * ppm / 1e6 + 2.5e3) / 5e3))
    f_search_set = matlab_range(-n_extra * 5000.0, 5000.0, n_extra * 5000.0)
    fc_search_set = matlab_range(freq_start, 100e3, freq_end)
    return fc_search_set, f_search_set


def detection_threshold(sp_incoherent: np.ndarray, n_comb_xc: int,
                        ds_comb_arm: int = DS_COMB_ARM,
                        thresh1_n_nines: int = THRESH1_N_NINES) -> np.ndarray:
    """Per-lag power threshold Z_th1 from the chi-squared false-alarm
    target (reference: src/CellSearch.cpp:500-503; derivation in
    Matlab/pss_search_final.m:207-255)."""
    dof = 2 * n_comb_xc * (2 * ds_comb_arm + 1)
    r_th1 = chi2cdf_inv(1 - 10.0 ** (-thresh1_n_nines), dof)
    return (r_th1 * sp_incoherent / RX_CUTOFF / 137 / 2
            / n_comb_xc / (2 * ds_comb_arm + 1))


def cell_search(
    capbuf: np.ndarray,
    fc_requested: float,
    fc_programmed: Optional[float] = None,
    fs_programmed: float = 1.92e6,
    f_search_set: Optional[Sequence[float]] = None,
    ds_comb_arm: int = DS_COMB_ARM,
    thresh2_n_sigma: float = THRESH2_N_SIGMA,
    interp: str = "hex",
    verbose: int = 0,
    device=None,
    backend: str = "torch",
) -> List[Cell]:
    """Full search of one capture buffer at one center frequency.

    Returns the fully decoded cells (every returned cell has a valid MIB).
    ``backend="torch"`` runs on ``device``: ``None`` is the CUDA card (it
    raises if there is none), ``"cpu"`` the kernels' plain PyTorch
    versions. Float32 matrix products and convolutions run in full float32
    (this sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False): TF32 would flip
    near-tie argmaxes of the 168-hypothesis SSS scan. ``interp`` "hex" or
    "freq_time" (there "2stage" runs as "freq_time").

    ``backend="numpy"`` runs the float64 host chain on the CPU and ignores
    ``device``; ``interp`` is "hex", "freq_time" or "2stage".
    """
    if backend not in ("torch", "numpy"):
        raise ValueError(f"backend must be 'torch' or 'numpy', not "
                         f"{backend!r}")
    if fc_programmed is None:
        fc_programmed = fc_requested
    if f_search_set is None:
        f_search_set = np.array([0.0])
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    if backend == "numpy":
        return _host_search(np.asarray(capbuf, dtype=np.complex128),
                            fc_requested, fc_programmed, fs_programmed,
                            f_search_set, ds_comb_arm, thresh2_n_sigma,
                            interp, verbose)
    with TRACER.span("search"):
        with TRACER.span("search.upload"):
            dev = resolve_device(device)
            full_f32_matmuls()
            capbuf = np.asarray(capbuf, dtype=np.complex128)
            cap_ri = torch.from_numpy(np.stack(
                [capbuf.real, capbuf.imag], -1).astype(np.float32)).to(dev)

        # ---- scan + threshold + greedy peaks, on the device.
        with TRACER.span("search.scan"):
            plan = scan_plan(len(capbuf), f_search_set, fc_requested,
                             fc_programmed, fs_programmed)
            packed, single, _ = xcorr_core(cap_ri.T.contiguous(), plan,
                                           ds_comb_arm)
        with TRACER.span("search.peaks"):
            r_norm = r_th1_normalized(plan.n_comb_xc, ds_comb_arm,
                                      THRESH1_N_NINES)
            peaks = peaks_to_cells(peak_search(packed, single, r_norm,
                                               ds_comb_arm),
                                   f_search_set, fc_requested, fc_programmed,
                                   fs_programmed)
        if verbose:
            print(f"  {len(peaks)} candidate peak(s)")

        # ---- SSS detection + fine FOE, then the blind MIB per CP type.
        with TRACER.span("search.sync"):
            synced = sss_foe_batch(peaks, cap_ri, thresh2_n_sigma)
        alive = [c for c in synced if c.n_id_1 >= 0]
        if verbose >= 2 and len(alive) < len(synced):
            print(f"    {len(synced) - len(alive)} peak(s) failed SSS "
                  "detection")
        detected: List[Cell] = []
        with TRACER.span("search.mib"):
            for cp in ("normal", "extended"):
                group = [c for c in alive if c.cp_type == cp]
                for cell in decode_mib_batch(group, cap_ri, interp=interp):
                    if cell.n_rb_dl < 0:
                        if verbose >= 2:
                            print("    peak failed MIB decode")
                        continue
                    detected.append(cell)
                    if verbose:
                        print(f"  cell ID {cell.n_id_cell()}: {cell.n_rb_dl} "
                              f"RB, {cell.cp_type} CP, foff "
                              f"{cell.freq_superfine:+.1f} Hz")
        return detected


def _host_search(capbuf, fc_requested, fc_programmed, fs_programmed,
                 f_search_set, ds_comb_arm, thresh2_n_sigma, interp,
                 verbose) -> List[Cell]:
    """The float64 host chain of :func:`cell_search`, one candidate at a
    time (the JAX package's ``backend="numpy"`` loop)."""
    r = xcorr_pss(capbuf, f_search_set, ds_comb_arm, fc_requested,
                  fc_programmed, fs_programmed)
    z_th1 = detection_threshold(r.sp_incoherent, r.n_comb_xc, ds_comb_arm)
    peaks = host_peak.peak_search(
        r.xc_incoherent_collapsed_pow, r.xc_incoherent_collapsed_frq, z_th1,
        f_search_set, fc_requested, fc_programmed, r.xc_incoherent_single,
        ds_comb_arm, fs_programmed)
    if verbose:
        print(f"  {len(peaks)} candidate peak(s)")
    detected: List[Cell] = []
    for cell in peaks:
        cell = sss_detect(cell, capbuf, thresh2_n_sigma, fc_requested,
                          fc_programmed, fs_programmed)
        if cell.n_id_1 < 0:
            if verbose >= 2:
                print("    peak failed SSS detection")
            continue
        cell = pss_sss_foe(cell, capbuf, fc_requested, fc_programmed,
                           fs_programmed)
        tfg, tfg_timestamp = extract_tfg(cell, capbuf, fc_requested,
                                         fc_programmed, fs_programmed)
        rs_dl = RSDL(cell.n_id_cell(), 6, cell.cp_type)
        cell, tfg_comp, _ = tfoec(cell, tfg, tfg_timestamp, fc_requested,
                                  fc_programmed, rs_dl)
        cell = decode_mib(cell, tfg_comp, rs_dl, interp=interp)
        if cell.n_rb_dl < 0:
            if verbose >= 2:
                print("    peak failed MIB decode")
            continue
        detected.append(cell)
        if verbose:
            print(f"  cell ID {cell.n_id_cell()}: {cell.n_rb_dl} RB, "
                  f"{cell.cp_type} CP, foff {cell.freq_superfine:+.1f} Hz")
    return detected


def peak_search(packed: torch.Tensor, single: torch.Tensor, r_norm: float,
                ds_comb_arm: int) -> np.ndarray:
    """The search's peak stage on one capture's scan tables, on their
    device: the greedy loop's first pass at MAX_PEAKS trips, redone
    unbounded there if its table filled
    (:func:`~lte_cell_scanner_tpu_torch.ops.peak_torch.redo_full_tables`).
    Returns the host table, its unused slots at pow 0."""
    table = to_host(peak_search_device(packed, single, r_norm, ds_comb_arm,
                                       max_peaks=MAX_PEAKS))
    return redo_full_tables(table[None], packed[None], single[None], r_norm,
                            ds_comb_arm)[0]


def dedup(cells: List[Cell]) -> List[Cell]:
    """Merge duplicate detections of the same cell within 1 MHz; keep the
    strongest (reference: src/CellSearch.cpp:285-319)."""
    final: List[Cell] = []
    for c in cells:
        for i, f in enumerate(final):
            if (c.n_id_cell() == f.n_id_cell()
                    and abs((c.fc_requested + c.freq_superfine)
                            - (f.fc_requested + f.freq_superfine)) < 1e6):
                if c.pss_pow > f.pss_pow:
                    final[i] = c
                break
        else:
            final.append(c)
    return final
