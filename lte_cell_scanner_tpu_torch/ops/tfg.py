"""Symbol timing of the time/frequency grid.

reference: src/searcher.cpp:852-935 (extract_tfg). The MIB planner
(ops/mib_torch.py::mib_plan) takes its symbol start times from here.
"""

from __future__ import annotations

import numpy as np

from lte_cell_scanner_tpu_torch.constants import FS_LTE

# Subcarrier index relative to DC for the 72 kept subcarriers.
CN = np.concatenate([np.arange(-36, 0), np.arange(1, 37)]).astype(np.float64)


def symbol_timestamps_batch(cp_type: str, frame_start: np.ndarray,
                            fs_programmed: np.ndarray,
                            k_factor: np.ndarray) -> np.ndarray:
    """(n,) float64 inputs -> (n, n_ofdm) fractional DFT start times of
    6 frames + 2 slots of OFDM symbols: the CP offsets, the 0.01-subframe
    early-start rule and the per-CP increment pattern."""
    frame_start = np.asarray(frame_start, np.float64)
    fs_programmed = np.asarray(fs_programmed, np.float64)
    k_factor = np.asarray(k_factor, np.float64)
    n_symb_dl = 7 if cp_type == "normal" else 6
    u = 16.0 / FS_LTE * fs_programmed * k_factor
    dft_loc = frame_start + (10.0 if cp_type == "normal" else 32.0) * u

    # See if we can start one subframe earlier.
    early = dft_loc - 0.01 * fs_programmed * k_factor
    dft_loc = np.where(early > -0.5, early, dft_loc)

    n_ofdm = 6 * 10 * 2 * n_symb_dl + 2 * n_symb_dl
    if n_symb_dl == 6:
        pat = np.full(n_ofdm - 1, 128.0 + 32.0)
    else:
        pat = np.tile(128.0 + np.array([9, 9, 9, 9, 9, 9, 10],
                                       np.float64),
                      (n_ofdm + 6) // 7)[:n_ofdm - 1]
    incs = pat[None, :] * u[:, None]
    # np.cumsum is strictly sequential per row, so seeding it with
    # dft_loc reproduces the reference's scalar accumulation loop
    # bit-exactly (the round() of these timestamps picks the DFT sample).
    return np.cumsum(np.concatenate([dft_loc[:, None], incs], axis=1),
                     axis=1)
