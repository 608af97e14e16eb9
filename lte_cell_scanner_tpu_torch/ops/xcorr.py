"""Host (float64) planning of the PSS scan: shifted templates, per-fold
start indices and fold counts.

reference: src/searcher.cpp:113-308. The scan itself runs in
ops/xcorr_torch.py; everything that depends on k_factor is evaluated here
in float64 and handed to it as small arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lte_cell_scanner_tpu_torch.constants import HALF_FRAME, PSS_TD_LEN
from lte_cell_scanner_tpu_torch.models.pss import pss_td_all


@dataclasses.dataclass
class XcorrResult:
    """Outputs of the PSS scan on the host (naming follows the reference;
    the JAX package's ops/xcorr.py::XcorrResult, without its host-only
    fields)."""

    # (3, 9600) peak power / best frequency-hypothesis index per lag
    xc_incoherent_collapsed_pow: np.ndarray
    xc_incoherent_collapsed_frq: np.ndarray
    # (3, 9600, n_f) per-hypothesis incoherent sums and their delay spread
    xc_incoherent_single: np.ndarray
    xc_incoherent: Optional[np.ndarray]
    # (9600,) folded mean received power, aligned to correlation peaks
    sp_incoherent: np.ndarray
    n_comb_xc: int
    n_comb_sp: int


def shifted_templates(f_search_set: np.ndarray, fc_requested: float,
                      fc_programmed: float, fs_programmed: float
                      ) -> np.ndarray:
    """(n_f, 3, 137) conjugated, 1/137-scaled, frequency-shifted PSS
    templates. Each hypothesis f_off shifts at its own true sample rate
    fs_programmed * k_factor (reference: src/searcher.cpp:145-151)."""
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    k_factor = (fc_requested - f_search_set) / fc_programmed  # (n_f,)
    fs_eff = fs_programmed * k_factor[:, None]
    t = np.arange(PSS_TD_LEN, dtype=np.float64)
    # fshift: exp(+j*2*pi*f*t/fs); then conjugate the whole template.
    phase = 2.0 * np.pi * f_search_set[:, None] * t[None, :] / fs_eff
    templates = pss_td_all()[None, :, :] * np.exp(1j * phase)[:, None, :]
    return np.conj(templates) / PSS_TD_LEN


def fold_start_indices(f_search_set: np.ndarray, n_comb_xc: int,
                       fc_requested: float, fc_programmed: float,
                       fs_programmed: float) -> np.ndarray:
    """(n_f, n_comb_xc) start lag of each half-frame fold, corrected per
    hypothesis by k_factor (reference: src/searcher.cpp:292-299)."""
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    k_factor = (fc_requested - f_search_set) / fc_programmed
    m = np.arange(n_comb_xc, dtype=np.float64)
    idx = np.round(m[None, :] * 0.005 * k_factor[:, None] * fs_programmed)
    return idx.astype(np.int64)


def n_comb_sp_for(n_cap: int) -> int:
    """Number of half-frame folds in the signal-power estimate
    (reference: src/searcher.cpp:185-221)."""
    return (n_cap - (PSS_TD_LEN - 1) - PSS_TD_LEN) // HALF_FRAME


def n_comb_xc_for(n_lags: int, f_search_set: np.ndarray,
                  fc_requested: float, fc_programmed: float,
                  fs_programmed: float) -> int:
    """Number of incoherent fold segments, reduced (rarely) so that every
    hypothesis's last fold window stays inside the correlation buffer.

    The nominal count (n_lags - 100) // 9600 carries a 100-sample margin
    for k_factor stride drift (src/searcher.cpp:263-308); on captures much
    longer than 80 ms at high ppm the drift can exceed it.
    """
    n = (n_lags - 100) // HALF_FRAME
    while n > 1:
        starts = fold_start_indices(f_search_set, n, fc_requested,
                                    fc_programmed, fs_programmed)
        if int(starts[:, -1].max()) + HALF_FRAME <= n_lags:
            break
        n -= 1
    return n
