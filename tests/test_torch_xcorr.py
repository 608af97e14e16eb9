"""PyTorch port of the PSS scan (lte_cell_scanner_tpu_torch/ops/xcorr_torch.py)
vs the JAX package: the fold against the Pallas kernels K1 (TEA layout), K2
(roll layout) and K3 (Karatsuba, tea3) in interpret mode, in f32 and bf16,
and the packed tables against the f32 XLA path. On the CPU the port runs its
kernels' plain versions.

Tolerance of every fold comparison: rtol 1e-5 + atol 1e-6 * max, the JAX
package's own bound for tea3 against roll (tests/test_xcorr_pallas.py): f32
sums over the 137 taps in another order, and Karatsuba's im = k3 - k1 - k2
cancels. The bf16 mode rounds at the same points in both packages and sums
exact bf16 products in f32, so it holds the same f32-level tolerance.
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.ops.xcorr_jax import xcorr_pss_jax
from lte_cell_scanner_tpu.ops.xcorr_pallas import scan_plan as jax_scan_plan
from lte_cell_scanner_tpu.ops.xcorr_pallas import xcorr_single_pallas
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import (karatsuba_planes,
                                                        round_bf16,
                                                        scan_plan,
                                                        xcorr_core,
                                                        xcorr_fold,
                                                        xcorr_fold3)

FC = 739e6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the machine's cores among several test
    processes: keep this module's torch work on one thread so that it does
    not starve the timing tests running beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _single(cap, fset, layout="tea", precision="f32"):
    """The fold as xcorr_core runs it for ``layout`` and ``precision``."""
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6, layout=layout,
                     precision=precision)
    cap2 = _cap2(cap)
    args = (torch.from_numpy(plan.tpl), torch.from_numpy(plan.starts),
            plan.n_comb_xc)
    if layout == "tea3":
        single = xcorr_fold3(karatsuba_planes(cap2, precision), *args)
    else:
        single = xcorr_fold(round_bf16(cap2) if precision == "bf16"
                            else cap2, *args)
    return single.numpy().astype(np.float64), plan


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


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


@pytest.mark.parametrize("layout,precision", [
    ("tea3", "f32"), ("tea3", "bf16"), ("tea", "bf16")])
def test_fold_layouts_match_pallas(layout, precision):
    """K3 (and K1 in bf16) against the Pallas kernel in interpret mode at
    the same layout and precision; tea3 in f32 also against the 2x2
    kernel's plain version."""
    cap = _capture(n=48000, seed=11)
    fset = np.arange(-3, 4) * 5e3
    got, plan = _single(cap, fset, layout, precision)
    assert plan.tpl.shape == (7, 3, 3 if layout == "tea3" else 2, 137)
    want, n_comb_xc = xcorr_single_pallas(cap, fset, FC, FC, 1.92e6,
                                          interpret=True, layout=layout,
                                          precision=precision)
    assert plan.n_comb_xc == n_comb_xc
    _close(got, np.asarray(want, dtype=np.float64))
    if precision == "f32":
        _close(got, _single(cap, fset)[0])


def test_fold3_extreme_grid_matches_2x2():
    """The +-600 kHz grid, where JAX's tea3 plan does not fit and falls
    back to the roll layout: the port runs K3 all the same, and it agrees
    with the 2x2 kernel's plain version."""
    n_cap, fset = 86700, np.arange(-120, 121) * 5e3
    *_, offs, _, _, _, _ = jax_scan_plan(n_cap, fset, FC, FC, 1.92e6,
                                         layout="tea3")
    assert offs is not None
    cap = _capture(n=n_cap, seed=11)
    got, plan = _single(cap, fset, "tea3")
    assert plan.n_comb_xc == 9
    _close(got, _single(cap, fset)[0])


def test_core_tea3_matches_tea():
    """xcorr_core with the Karatsuba kernel on a simulator capture: the
    2x2 kernel's collapsed powers within rtol 1e-5, its frequency rows,
    signal power and peak positions exactly."""
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.ops.peak_torch import (
        peak_search_device, r_th1_normalized)

    cap = synthetic_capture(seed=4)
    fset = np.arange(-3, 4) * 5e3
    out = {}
    for layout in ("tea", "tea3"):
        plan = scan_plan(len(cap), fset, FC, FC, 1.92e6, layout=layout)
        packed, single, _ = xcorr_core(_cap2(cap), plan, 2)
        peaks = peak_search_device(packed, single,
                                   r_th1_normalized(plan.n_comb_xc, 2), 2)
        out[layout] = packed.numpy().astype(np.float64), peaks.numpy()
    (p_tea, k_tea), (p_tea3, k_tea3) = out["tea"], out["tea3"]
    np.testing.assert_allclose(p_tea3[0:3], p_tea[0:3], rtol=1e-5)
    np.testing.assert_array_equal(p_tea3[3:6], p_tea[3:6])
    np.testing.assert_array_equal(p_tea3[6], p_tea[6])
    # The peaks (lag, hypothesis, root) exactly; their powers as pow.
    np.testing.assert_array_equal(k_tea3[:, 1:], k_tea[:, 1:])
    np.testing.assert_allclose(k_tea3[:, 0], k_tea[:, 0], rtol=1e-5)
    assert (k_tea[:, 0] > 0).sum() >= 1
