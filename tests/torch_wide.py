"""Shared by tests/test_torch_frontend.py, tests/test_torch_wideband.py,
tests/test_torch_wideband_sc16.py and tests/test_torch_tracing.py: the
wideband recording of the JAX package's tests/test_wideband.py
(``_wide_two_cells``), built with the port's simulator and interpft, and
its sc16 form."""

import numpy as np

from lte_cell_scanner_tpu_torch.constants import FS_SEARCH
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.utils.dsp import interpft

FC_CENTER = 739e6


def wide_two_cells(decim=8, f_a=2.0e6, f_b=-1.5e6, seed=9):
    """Cell 271 (+3 kHz) at +2.0 MHz and cell 90 (-2 kHz) at -1.5 MHz,
    both normal CP, 50 RB, 90 subframes, upconverted into one
    decim x 1.92 Msps band around FC_CENTER. Returns (wide, fs_in)."""
    a = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=20, freq_offset=3e3,
                          n_subframes=90, seed=seed)
    b = synthetic_capture(n_id_1=30, n_id_2=0, snr_db=20, freq_offset=-2e3,
                          n_subframes=90, slot_start=6, sfn_start=400,
                          seed=seed + 1)
    fs_in = decim * FS_SEARCH
    wa = interpft(a, len(a) * decim)
    wb = interpft(b, len(b) * decim)
    t = np.arange(len(wa))
    wide = (wa * np.exp(2j * np.pi * f_a * t / fs_in)
            + wb * np.exp(2j * np.pi * f_b * t / fs_in))
    rng = np.random.default_rng(seed)
    wide = wide + 0.001 * (rng.standard_normal(len(wide))
                           + 1j * rng.standard_normal(len(wide)))
    return wide, fs_in


def to_sc16(sig, share=0.25):
    """A complex recording as an sc16 file holds it, (n, 2) int16: its
    largest I or Q value at ``share`` of full scale, rounded."""
    peak = max(np.abs(sig.real).max(), np.abs(sig.imag).max())
    x = sig * (share * 32768 / peak)
    return np.round(np.stack([x.real, x.imag], 1)).astype(np.int16)
