"""Capture-buffer front end: frequency shift + 6-RB decimating FIR.

Counterpart of lte_cell_scanner_tpu/io/frontend.py. The reference captures
at 1.92 Msps directly from the dongle, so its only front-end processing is
the uint8 conversion. This module adds the wideband path: captures recorded
at any integer multiple of 1.92 Msps (e.g. 15.36/30.72 Msps full-band LTE
recordings) are frequency-shifted to center the target carrier and
decimated to the 6-RB 1.92 Msps analysis rate through an anti-alias FIR.

The passband matches the searcher's occupancy assumption
(rx_cutoff = (6*12*15e3/2 + 4*15e3) of half the 960 kHz Nyquist,
src/CellSearch.cpp:501); the FIR is a Kaiser-windowed sinc designed for
>60 dB stopband rejection.

Polyphase decimation: the input reshapes to (n_out, decim) blocks and each
of the FIR's ``phases`` decim-wide tap slices contracts one shifted block
window, so the work is ``phases`` matrix-vector products. ``backend="torch"``
runs them in float32 on a torch device, the float64 NumPy path is the host
reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import FS_SEARCH
from lte_cell_scanner_tpu_torch.utils.device import (full_f32_matmuls,
                                                     resolve_device)

PASSBAND_HZ = 6 * 12 * 15e3 / 2 + 4 * 15e3     # 600 kHz, see rx_cutoff
STOP_ATTEN_DB = 60.0


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


@functools.lru_cache(maxsize=8)
def design_decimation_fir(decim: int, atten_db: float = STOP_ATTEN_DB
                          ) -> np.ndarray:
    """Anti-alias lowpass for decimation by ``decim`` from
    decim*1.92 Msps: passband 600 kHz, stopband at the alias edge
    (1.92 MHz - 600 kHz folds onto the passband edge)."""
    fs_in = decim * FS_SEARCH
    f_pass = PASSBAND_HZ
    f_stop = FS_SEARCH - PASSBAND_HZ       # first alias into the passband
    df = (f_stop - f_pass) / fs_in
    beta = _kaiser_beta(atten_db)
    n_taps = int(np.ceil((atten_db - 7.95) / (2.285 * 2 * np.pi * df)))
    n_taps = (n_taps // (2 * decim) + 1) * 2 * decim + 1  # odd, phase-align
    n = np.arange(n_taps) - (n_taps - 1) / 2
    fc = (f_pass + f_stop) / 2 / fs_in
    h = 2 * fc * np.sinc(2 * fc * n) * np.kaiser(n_taps, beta)
    return h / h.sum()


def decimation_factor(fs_in: float) -> int:
    """fs_in / 1.92 Msps; raises unless it is an integer."""
    decim = fs_in / FS_SEARCH
    if abs(decim - round(decim)) > 1e-9:
        raise ValueError(f"fs_in={fs_in} is not a multiple of 1.92 Msps")
    return int(round(decim))


def decimate_capture(x: np.ndarray, fs_in: float,
                     freq_shift: float = 0.0,
                     backend: str = "numpy", device=None) -> np.ndarray:
    """Shift ``freq_shift`` to baseband and decimate to 1.92 Msps.

    fs_in must be an integer multiple of 1.92 Msps. Returns the
    1.92 Msps complex capture (length floor(len(x)/decim) minus FIR
    startup). ``backend="numpy"`` is the float64 host reference;
    ``backend="torch"`` runs the polyphase products in float32 on
    ``device`` (``None``: the CUDA card, raising without one;
    ``"cpu"``: the plain PyTorch products). The frequency shift is applied
    in float64 on the host either way.
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    decim = decimation_factor(fs_in)
    x = np.asarray(x, dtype=complex)
    if freq_shift:
        t = np.arange(len(x))
        x = x * np.exp(-2j * np.pi * freq_shift * t / fs_in)
    if decim == 1:
        return x

    h = design_decimation_fir(decim)
    n_taps = len(h)
    # Polyphase: y[m] = sum_j h_rev[j] x[m*decim + j]
    #          = sum_q X[m + q] . taps_q
    # with X the (n_blocks, decim) reshape of x and taps_q the q-th
    # decim-wide slice of the reversed taps — `phases` matrix-vector
    # products of (n_out, decim) blocks, O(n_out) memory (not the
    # O(n_out * n_taps) im2col form).
    taps = h[::-1].copy()
    phases = -(-n_taps // decim)
    taps = np.pad(taps, (0, phases * decim - n_taps))
    n_blocks = len(x) // decim
    xb = x[:n_blocks * decim].reshape(n_blocks, decim)
    # Output count from the *blocked* length: every phase slice
    # xb[q:q+n_out] must fit in n_blocks rows (a tail of len(x) that is
    # not a whole block is dropped, so deriving n_out from len(x) would
    # leave the last phase's slice one row short for most input lengths).
    n_out = n_blocks - phases + 1
    if n_out < 1:
        raise ValueError(
            f"capture too short to decimate: {len(x)} samples < "
            f"{phases * decim} ({n_taps}-tap FIR at decim={decim})")

    tp = taps.reshape(phases, decim)
    if backend == "torch":
        dev = resolve_device(device)
        full_f32_matmuls()
        xr = torch.from_numpy(xb.real.astype(np.float32)).to(dev)
        xi = torch.from_numpy(xb.imag.astype(np.float32)).to(dev)
        tq = torch.from_numpy(tp.astype(np.float32)).to(dev)
        yr = torch.zeros(n_out, dtype=torch.float32, device=dev)
        yi = torch.zeros(n_out, dtype=torch.float32, device=dev)
        for q in range(phases):
            yr += xr[q:q + n_out] @ tq[q]
            yi += xi[q:q + n_out] @ tq[q]
        return (yr.cpu().numpy().astype(np.float64)
                + 1j * yi.cpu().numpy().astype(np.float64))

    y = np.zeros(n_out, dtype=complex)
    for q in range(phases):
        y += xb[q:q + n_out] @ tp[q]
    return y
