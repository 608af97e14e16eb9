"""PyTorch port of the fused symbol demod (lte_cell_scanner_tpu_torch/
ops/fd_demod.py, plain version on the CPU) vs the JAX Pallas kernel K4 in
its MIB mode (pre_bpo=True, the _dft72 matrices) in interpret mode; the
named DFT (bins, cyclic shift) vs the JAX package's matrices; and the
route the CUDA kernel takes (a 128-point FFT, the bin selection and the
per-bin shift factor) vs the plain versions of both modes.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_cell_scanner_tpu.ops.fd_demod_pallas import (fd_demod_pallas,
                                                      planar_rows_f32)
from lte_cell_scanner_tpu.ops.mib_jax import _dft72 as jax_dft72
from lte_cell_scanner_tpu.ops.tfg import CN as JAX_CN
from lte_cell_scanner_tpu.tracker.batch_frontend import \
    _dft_mats as jax_dft_mats
from lte_cell_scanner_tpu_torch.ops.fd_demod import (
    MIB_DFT, TRACKER_DFT, fd_demod, fd_demod_plain, fd_demod_stream_plain)
from lte_cell_scanner_tpu_torch.ops.sync_torch import (_aligned_wins, cmul,
                                                       rot_pair)
from lte_cell_scanner_tpu_torch.ops.tfg import CN
from lte_cell_scanner_tpu_torch.tracker.batch_frontend import (dft_cn,
                                                              dft_mats)
from torch_one_thread import _one_torch_thread  # noqa: F401


def test_tables_match_jax():
    for a, b in zip(dft_mats(MIB_DFT), jax_dft72()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(CN, JAX_CN)


@pytest.mark.parametrize("dft,want", [(MIB_DFT, jax_dft72),
                                      (TRACKER_DFT, jax_dft_mats)],
                         ids=["mib", "tracker"])
def test_named_dft_reproduces_matrices(dft, want):
    """The (bins, shift) table gives the JAX package's _dft72 (shift 0)
    and _dft_mats (shift 2) to f32 rounding, and cn is the signed bin."""
    for a, b in zip(dft_mats(dft), want()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=float(
            np.finfo(np.float32).eps))
    np.testing.assert_array_equal(dft_cn(dft), JAX_CN.astype(np.float32))
    # The matrix is the FFT's bins times the per-bin shift factor.
    t = np.arange(128)
    x = np.exp(2j * np.pi * np.outer(t, t) / 128.0)     # rows: test inputs
    bins = np.asarray(dft.bins)
    fft = np.fft.fft(x, axis=-1)[:, bins] * np.exp(
        2j * np.pi * dft.shift * bins / 128.0) / np.sqrt(128.0)
    wr, wi = dft_mats(dft)
    np.testing.assert_allclose(x @ (wr + 1j * wi.astype(np.float64)), fft,
                               rtol=0, atol=1e-5)


def test_fd_demod_matches_pallas():
    rng = np.random.default_rng(0)
    n_cap = 128 * 60 + 37                  # not a multiple of 128: zero pad
    cap = rng.standard_normal((n_cap, 2)).astype(np.float32)
    n = 300
    idx = rng.integers(0, n_cap - 128, n).astype(np.int32)
    # Row-straddling, first and last windows (the last ones read the pad
    # and the clamped row).
    idx[:6] = [0, 1, 127, 128, n_cap - 128, n_cap - 1]
    foc = rng.uniform(-0.05, 0.05, n).astype(np.float32)
    bpo = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    late = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    wr, wi = jax_dft72()
    cn = JAX_CN.astype(np.float32)

    t = torch.from_numpy
    got = fd_demod(t(cap), t(idx), t(foc), t(bpo), t(late), MIB_DFT).numpy()
    ra, ia, ra1, ia1, bofs = planar_rows_f32(jnp.asarray(cap),
                                             jnp.asarray(idx))
    want = np.asarray(fd_demod_pallas(
        ra, ia, ra1, ia1, bofs, jnp.asarray(foc), jnp.asarray(bpo),
        jnp.asarray(late), mats=(wr, wi, cn), pre_bpo=True, interpret=True))
    assert got.shape == want.shape == (n, 72, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _edge_starts(rng, n_samples):
    """Window starts at the edges: 0, every b = start mod 128 in 0..127
    (random rows), the last row and windows running past the end of the
    samples (their rows clamp and read the pad)."""
    n_rows = -(-n_samples // 128)
    every_b = 128 * rng.integers(0, n_rows - 1, 128) + np.arange(128)
    last = [n_samples - 128, n_samples - 64, n_samples - 1,
            128 * (n_rows - 1), n_samples + 3, n_samples + 200]
    return np.concatenate([[0], every_b, last,
                           rng.integers(0, n_samples, 40)]).astype(np.int32)


def _fft_route(samples, idx, foc, bpo, late, dft, pre_bpo):
    """The kernel's route in numpy: the plain version's gather and f32
    rotation angles, then a complex128 128-point FFT, the bin selection
    and the per-bin shift factor exp(+2*pi*i*shift*bin/128)/sqrt(128)."""
    g, j, b = _aligned_wins(samples, idx)
    ph = bpo[:, None] + foc[:, None] * j if pre_bpo else foc[:, None] * j
    x = cmul(g, rot_pair(ph)).double().numpy()
    bins = np.asarray(dft.bins)
    y = np.fft.fft(x[..., 0] + 1j * x[..., 1], axis=-1)[:, bins] * np.exp(
        2j * np.pi * dft.shift * bins / 128.0) / np.sqrt(128.0)
    cn = torch.from_numpy(dft_cn(dft))
    lb = (late - b.to(torch.float32))[:, None]
    if pre_bpo:
        ang = -2.0 * math.pi * lb * cn / 128.0
    else:
        ang = bpo[:, None] - 2 * np.pi * lb * cn / 128.0
    out = y * np.exp(1j * ang.double().numpy())
    return np.stack([out.real, out.imag], axis=-1)


@pytest.mark.parametrize("mode", ["mib", "stream"])
def test_fft_route_matches_plain(mode):
    """FFT, bin selection and shift factor reproduce both plain versions
    (dense matrices) within 1e-5 x max, at the edge starts."""
    rng = np.random.default_rng(11)
    n_samples = 128 * 24 + 77
    t = torch.from_numpy
    if mode == "mib":
        samples = t(rng.standard_normal((n_samples, 2)).astype(np.float32))
        kernel_in = samples
    else:
        samples = t(rng.integers(0, 256, (n_samples, 2), dtype=np.uint8))
        kernel_in = (samples.to(torch.float32) - 127.0) * (1.0 / 128.0)
    idx = t(_edge_starts(rng, n_samples))
    n = idx.shape[0]
    foc = t(rng.uniform(-0.05, 0.05, n).astype(np.float32))
    bpo = t(rng.uniform(-np.pi, np.pi, n).astype(np.float32))
    late = t(rng.uniform(-2, 2, n).astype(np.float32))
    if mode == "mib":
        want = fd_demod_plain(samples, idx, foc, bpo, late, MIB_DFT)
        got = _fft_route(kernel_in, idx, foc, bpo, late, MIB_DFT, True)
    else:
        want = fd_demod_stream_plain(samples, idx, foc, bpo, late)
        got = _fft_route(kernel_in, idx, foc, bpo, late, TRACKER_DFT, False)
    want = want.numpy()
    assert got.shape == want.shape == (n, 72, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
