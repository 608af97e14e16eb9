"""Cell search of one capture in float64 on the host: the reference that
decides ``correct`` in the search cells and finds the cells of a tracker
recording.

A copy of the port's ``cell_search(backend="numpy")`` loop (reference:
src/CellSearch.cpp:437-618): xcorr_pss -> threshold -> peak_search, then
per candidate sss_detect -> pss_sss_foe -> extract_tfg -> tfoec ->
decode_mib. ``benchmark/control.py`` runs it in TF32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from benchmark.reference import xcorr
from benchmark.reference.cell import Cell
from benchmark.reference.constants import (DS_COMB_ARM, RX_CUTOFF,
                                           THRESH1_N_NINES, THRESH2_N_SIGMA)
from benchmark.reference.dsp import chi2cdf_inv, matlab_range
from benchmark.reference.pbch import decode_mib
from benchmark.reference.peak import peak_search
from benchmark.reference.rs import RSDL
from benchmark.reference.sync import pss_sss_foe, sss_detect
from benchmark.reference.tfg import extract_tfg, tfoec

def search_sets(freq_start: float, freq_end: float, ppm: float,
                raster_hz: float = 100e3):
    """Center-frequency sweep (the 100 kHz raster) and per-fc offset grid
    (reference: src/CellSearch.cpp:463-465)."""
    n_extra = int(np.floor((freq_start * ppm / 1e6 + 2.5e3) / 5e3))
    f_search_set = matlab_range(-n_extra * 5000.0, 5000.0, n_extra * 5000.0)
    fc_search_set = matlab_range(freq_start, raster_hz, freq_end)
    return fc_search_set, f_search_set


def detection_threshold(sp_incoherent: np.ndarray, n_comb_xc: int,
                        ds_comb_arm: int = DS_COMB_ARM) -> np.ndarray:
    """Per-lag power threshold Z_th1
    (reference: src/CellSearch.cpp:500-503)."""
    dof = 2 * n_comb_xc * (2 * ds_comb_arm + 1)
    r_th1 = chi2cdf_inv(1 - 10.0 ** (-THRESH1_N_NINES), dof)
    return (r_th1 * sp_incoherent / RX_CUTOFF / 137 / 2
            / n_comb_xc / (2 * ds_comb_arm + 1))


def cell_search(capbuf: np.ndarray, fc: float,
                f_search_set: Optional[Sequence[float]] = None,
                fs: float = 1.92e6, interp: str = "hex") -> List[Cell]:
    """Every cell of one capture whose MIB decodes, in float64. ``fc`` is
    requested and programmed alike."""
    capbuf = np.asarray(capbuf, dtype=np.complex128)
    f_search_set = np.asarray(
        [0.0] if f_search_set is None else f_search_set, dtype=np.float64)
    r = xcorr.xcorr_pss(capbuf, f_search_set, DS_COMB_ARM, fc, fc, fs)
    z_th1 = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    peaks = peak_search(r.xc_incoherent_collapsed_pow,
                        r.xc_incoherent_collapsed_frq, z_th1, f_search_set,
                        fc, fc, r.xc_incoherent_single, DS_COMB_ARM, fs)
    found: List[Cell] = []
    for cell in peaks:
        cell = sss_detect(cell, capbuf, THRESH2_N_SIGMA, fc, fc, fs)
        if cell.n_id_1 < 0:
            continue
        cell = pss_sss_foe(cell, capbuf, fc, fc, fs)
        tfg, tfg_timestamp = extract_tfg(cell, capbuf, fc, fc, fs)
        rs_dl = RSDL(cell.n_id_cell(), 6, cell.cp_type)
        cell, tfg_comp, _ = tfoec(cell, tfg, tfg_timestamp, fc, fc, rs_dl)
        cell = decode_mib(cell, tfg_comp, rs_dl, interp=interp)
        if cell.n_rb_dl >= 0:
            found.append(cell)
    return found
