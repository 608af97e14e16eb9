"""The port's wideband front end (io/frontend.py, utils/dsp.interpft)
against the JAX package's on the same inputs, on the CPU.

Tolerances: the FIR, interpft and the float64 numpy decimation are the
same numpy code, so they are bit-equal; the float32 torch decimation
(device="cpu") is held to the float64 path within 1e-4 x max, as the JAX
package's tests/test_frontend.py holds its float32 "jax" backend.
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.io import frontend as jax_frontend
from lte_cell_scanner_tpu.utils.dsp import interpft as jax_interpft
from lte_cell_scanner_tpu_torch.constants import FS_SEARCH
from lte_cell_scanner_tpu_torch.io import frontend
from lte_cell_scanner_tpu_torch.utils.dsp import interpft
from torch_one_thread import _one_torch_thread  # noqa: F401
from torch_wide import wide_two_cells

BACKENDS = [dict(backend="numpy"), dict(backend="torch", device="cpu")]


@pytest.fixture(scope="module")
def wide():
    return wide_two_cells()


def _tone(f, fs, n):
    return np.exp(2j * np.pi * f * np.arange(n) / fs)


@pytest.mark.parametrize("decim", [2, 4, 8, 16])
def test_fir_matches_jax(decim):
    got = frontend.design_decimation_fir(decim)
    want = jax_frontend.design_decimation_fir(decim)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert frontend.PASSBAND_HZ == jax_frontend.PASSBAND_HZ
    assert frontend.STOP_ATTEN_DB == jax_frontend.STOP_ATTEN_DB
    for atten in (10.0, 30.0, 60.0):
        assert frontend._kaiser_beta(atten) == jax_frontend._kaiser_beta(atten)


@pytest.mark.parametrize("m, n_y", [(1000, 8000), (999, 4000), (64, 64),
                                    (1000, 300)])
def test_interpft_matches_jax(m, n_y):
    rng = np.random.default_rng(m + n_y)
    x = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    got = interpft(x, n_y)
    assert len(got) == n_y and np.array_equal(got, jax_interpft(x, n_y))
    with pytest.raises(ValueError):
        interpft(x, 0)


def test_decimate_numpy_matches_jax(wide):
    sig, fs_in = wide
    for shift in (0.0, 2.0e6, -1.5e6):
        got = frontend.decimate_capture(sig, fs_in, freq_shift=shift)
        want = jax_frontend.decimate_capture(sig, fs_in, freq_shift=shift)
        assert np.array_equal(got, want)


def test_decimate_torch_matches_jax_numpy(wide):
    sig, fs_in = wide
    rng = np.random.default_rng(0)
    x = rng.standard_normal(40000) + 1j * rng.standard_normal(40000)
    for sig_, fs_, shift in ((sig, fs_in, 2.0e6), (x, 4 * FS_SEARCH, 0.0)):
        want = jax_frontend.decimate_capture(sig_, fs_, freq_shift=shift)
        got = frontend.decimate_capture(sig_, fs_, freq_shift=shift,
                                        backend="torch", device="cpu")
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("kw", BACKENDS, ids=["numpy", "torch"])
def test_fir_passband_and_alias_rejection(kw):
    """tests/test_frontend.py's case on the port, both backends."""
    fs_in = 8 * FS_SEARCH
    n = 1 << 16
    y = frontend.decimate_capture(_tone(300e3, fs_in, n), fs_in, **kw)
    assert abs(np.abs(y[200:-200]).mean() - 1.0) < 0.01
    # A tone that would alias onto 300 kHz is rejected by >55 dB.
    y = frontend.decimate_capture(_tone(FS_SEARCH + 300e3, fs_in, n), fs_in,
                                  **kw)
    assert 20 * np.log10(np.abs(y[200:-200]).mean() + 1e-12) < -55
    # The frequency shift centers an off-carrier signal first.
    y = frontend.decimate_capture(_tone(5e6 + 100e3, fs_in, n), fs_in,
                                  freq_shift=5e6, **kw)
    assert abs(np.abs(y[200:-200]).mean() - 1.0) < 0.01


@pytest.mark.parametrize("kw", BACKENDS, ids=["numpy", "torch"])
def test_arbitrary_input_lengths(kw):
    """Captures whose length is not a multiple of decim decimate to the
    same samples (tests/test_frontend.py's case)."""
    rng = np.random.default_rng(1)
    fs_in = 8 * FS_SEARCH
    base = rng.standard_normal(65544) + 1j * rng.standard_normal(65544)
    ref = frontend.decimate_capture(base, fs_in, **kw)
    for n in (65541, 65543, 65537):
        y = frontend.decimate_capture(base[:n], fs_in, **kw)
        assert len(y) >= len(ref) - 1
        m = min(len(y), len(ref))
        np.testing.assert_allclose(y[:m], ref[:m], atol=1e-12)


def test_decimate_rejects_bad_input():
    x = np.ones(4096, dtype=complex)
    with pytest.raises(ValueError, match="not a multiple of 1.92 Msps"):
        frontend.decimate_capture(x, 3e6)
    with pytest.raises(ValueError, match="unknown backend"):
        frontend.decimate_capture(x, 4 * FS_SEARCH, backend="jax")
    with pytest.raises(ValueError, match="too short"):
        frontend.decimate_capture(x[:50], 8 * FS_SEARCH)
    if torch.cuda.is_available():
        return
    # Without CUDA the torch backend raises unless asked for the CPU.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frontend.decimate_capture(x, 4 * FS_SEARCH, backend="torch")


def test_decimated_capture_to_cell_search(wide):
    """The torch-decimated carrier of the two-cell recording decodes as
    the JAX package's float64 one does."""
    from lte_cell_scanner_tpu.search.cell_search import \
        cell_search as jax_cell_search
    from lte_cell_scanner_tpu_torch.search.cell_search import cell_search

    sig, fs_in = wide
    fset = np.arange(-2, 3) * 5e3
    got = frontend.decimate_capture(sig, fs_in, freq_shift=2.0e6,
                                    backend="torch", device="cpu")[:153600]
    want = jax_frontend.decimate_capture(sig, fs_in,
                                         freq_shift=2.0e6)[:153600]
    cells = cell_search(got, 741e6, f_search_set=fset, device="cpu")
    ref = jax_cell_search(want, 741e6, f_search_set=fset, backend="numpy")
    assert [c.n_id_cell() for c in cells] == [c.n_id_cell() for c in ref] \
        == [271]
    assert cells[0].n_rb_dl == ref[0].n_rb_dl == 50
    assert abs(cells[0].freq_superfine - ref[0].freq_superfine) < 0.5
