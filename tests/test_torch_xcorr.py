"""PyTorch port of the PSS scan (lte_cell_scanner_tpu_torch/ops/xcorr_torch.py)
vs the JAX package: the fold against the Pallas kernels K1 (TEA layout) and
K2 (roll layout) in interpret mode, and the packed tables against the f32
XLA path. On the CPU the port runs its kernel's plain version.
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.ops.xcorr_jax import xcorr_pss_jax
from lte_cell_scanner_tpu.ops.xcorr_pallas import scan_plan as jax_scan_plan
from lte_cell_scanner_tpu.ops.xcorr_pallas import xcorr_single_pallas
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import (scan_plan,
                                                        xcorr_core,
                                                        xcorr_fold)

FC = 739e6


def _capture(n=48000, seed=0, f_off=10e3):
    from lte_cell_scanner_tpu_torch.models.pss import pss_td

    rng = np.random.default_rng(seed)
    cap = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
    sh = pss_td(1) * np.exp(1j * 2 * np.pi * f_off * np.arange(137) / 1.92e6)
    for k in range(500, n - 137, 9600):
        cap[k:k + 137] += 0.3 * sh
    return cap


def _cap2(cap):
    return torch.from_numpy(np.stack([cap.real, cap.imag]).astype(np.float32))


def _single(cap, fset):
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    single = xcorr_fold(_cap2(cap), torch.from_numpy(plan.tpl),
                        torch.from_numpy(plan.starts), plan.n_comb_xc)
    return single.numpy().astype(np.float64), plan


@pytest.mark.parametrize("layout,n_cap,fset", [
    ("tea", 48000, np.arange(-3, 4) * 5e3),
    ("roll", 48000, np.arange(-3, 4) * 5e3),
    # The extreme-ppm grid where JAX's TEA plan does not fit and the
    # scan falls back to the roll kernel (K2): nine folds, the shortest
    # capture at which the TEA bank no longer fits.
    ("roll", 86700, np.arange(-120, 121) * 5e3),
])
def test_fold_matches_pallas(layout, n_cap, fset):
    cap = _capture(n=n_cap, seed=11)
    if len(fset) > 100:
        *_, offs, _, _, _, _ = jax_scan_plan(n_cap, fset, FC, FC, 1.92e6)
        assert offs is not None          # JAX plans the roll layout here
    got, plan = _single(cap, fset)
    want, n_comb_xc = xcorr_single_pallas(cap, fset, FC, FC, 1.92e6,
                                          interpret=True, layout=layout)
    want = np.asarray(want, dtype=np.float64)
    assert plan.n_comb_xc == n_comb_xc
    assert got.shape == want.shape == (3, 9600, len(fset))
    # f32 with another summation order over the 137 taps.
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_packed_matches_xla_f32():
    cap = _capture(seed=3)
    fset = np.arange(-2, 3) * 5e3
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    packed, single, inc = xcorr_core(_cap2(cap), plan, 2)
    packed = packed.numpy().astype(np.float64)
    rj = xcorr_pss_jax(cap, fset, 2, FC, FC, 1.92e6, dtype=np.float32,
                       use_pallas=False)
    assert plan.n_comb_xc == rj.n_comb_xc
    assert plan.n_comb_sp == rj.n_comb_sp
    np.testing.assert_allclose(packed[0:3], rj.xc_incoherent_collapsed_pow,
                               rtol=1e-6)
    np.testing.assert_array_equal(packed[3:6].astype(np.int64),
                                  rj.xc_incoherent_collapsed_frq)
    np.testing.assert_allclose(packed[6], rj.sp_incoherent, rtol=1e-6)
    np.testing.assert_allclose(inc.numpy(), np.asarray(rj.xc_incoherent),
                               rtol=1e-5,
                               atol=1e-6 * np.abs(packed[0:3]).max())


def test_scan_tables_match_jax():
    from lte_cell_scanner_tpu.ops import xcorr as jax_xcorr
    from lte_cell_scanner_tpu_torch.ops import xcorr

    fset = np.arange(-15, 16) * 5e3
    np.testing.assert_array_equal(
        xcorr.shifted_templates(fset, FC, 739.1e6, 1.92e6),
        jax_xcorr.shifted_templates(fset, FC, 739.1e6, 1.92e6))
    n_comb = xcorr.n_comb_xc_for(153464, fset, FC, FC, 1.92e6)
    assert n_comb == jax_xcorr.n_comb_xc_for(153464, fset, FC, FC, 1.92e6)
    np.testing.assert_array_equal(
        xcorr.fold_start_indices(fset, n_comb, FC, FC, 1.92e6),
        jax_xcorr.fold_start_indices(fset, n_comb, FC, FC, 1.92e6))
