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
from lte_cell_scanner_tpu_torch.ops import xcorr_torch
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import (
    karatsuba_inputs, karatsuba_planes, round_bf16, scan_plan, tf32_round,
    xcorr_core, xcorr_fold, xcorr_fold3, xcorr_fold3_3xtf32_plain,
    xcorr_fold3_plain, xcorr_fold_3xtf32_plain, xcorr_fold_plain)
from torch_one_thread import _one_torch_thread  # noqa: F401

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


def test_matlab_mode_templates_match_jax():
    """shifted_templates(mode="matlab") (the nominal-rate shift of the
    Matlab prototype) equals the JAX package's to 0 ulp."""
    from lte_cell_scanner_tpu.ops import xcorr as jax_xcorr
    from lte_cell_scanner_tpu_torch.ops import xcorr

    fset = np.arange(-15, 16) * 5e3
    got = xcorr.shifted_templates(fset, FC, 739.1e6, 1.92e6, mode="matlab")
    np.testing.assert_array_equal(got, jax_xcorr.shifted_templates(
        fset, FC, 739.1e6, 1.92e6, mode="matlab"))
    assert not np.array_equal(got, xcorr.shifted_templates(
        fset, FC, 739.1e6, 1.92e6))


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


# ---- The tensor-core kernel's arithmetic (3xTF32) and indexing, on the CPU.

def test_tf32_round():
    """cvt.rna.tf32.f32: a 10-bit mantissa, round to nearest with ties away
    from zero (held against a float64 rounding of the significand), and the
    3xTF32 split hi + lo recovers x to 2^-21 relative."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)
         ).astype(np.float32)
    ties = np.float32(1.0) + np.float32(2.0 ** -11) * np.array(
        [1, 3, -1, -3], np.float32)                      # exact halfway cases
    x = np.concatenate([x, ties, -ties, [0.0, 1.0, -2.5]]).astype(np.float32)
    hi = tf32_round(torch.from_numpy(x))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    m, e = np.frexp(x.astype(np.float64))
    want = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), want)
    lo = tf32_round(torch.from_numpy(x) - hi)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x)
    assert (err <= 2.0 ** -21 * np.abs(x)).all()


def _fold_3xtf32(cap2, tpl, starts, n_comb_xc):
    """The kernel's products emulated on the CPU (split, three float32
    convolutions, |xc|^2, fold), as xcorr_fold returns it: (3, 9600, n_f)."""
    fold = xcorr_fold_3xtf32_plain(cap2, tpl, starts, n_comb_xc)
    return fold.view(tpl.shape[0], 3, 9600).permute(1, 2, 0)


def test_3xtf32_matches_plain():
    cap = _capture(seed=5)
    fset = np.arange(-15, 16) * 5e3
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    args = (_cap2(cap), torch.from_numpy(plan.tpl),
            torch.from_numpy(plan.starts), plan.n_comb_xc)
    want = xcorr_fold_plain(*args).view(31, 3, 9600).permute(1, 2, 0)
    _close(_fold_3xtf32(*args).numpy().astype(np.float64),
           want.numpy().astype(np.float64))


def test_3xtf32_error_near_float32():
    """Against a float64 reference, the split's products (the dropped
    lo*lo term included) summed in float32 err no more than twice as much
    as the plain float32 route: what the card's kernel adds beyond that
    comes from its accumulation."""
    cap = _capture(seed=5)
    fset = np.arange(-15, 16) * 5e3
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    cap2, tpl = _cap2(cap), torch.from_numpy(plan.tpl)
    starts = torch.from_numpy(plan.starts)
    ref = xcorr_fold_plain(cap2.double(), tpl.double(), starts,
                           plan.n_comb_xc)
    err_f32 = (xcorr_fold_plain(cap2, tpl, starts, plan.n_comb_xc).double()
               - ref).abs().max()
    err_split = (xcorr_fold_3xtf32_plain(cap2, tpl, starts, plan.n_comb_xc
                                         ).double() - ref).abs().max()
    assert 0 < err_f32 < 1e-5 * ref.abs().max()
    assert err_split <= 2 * err_f32


# The simulator captures of test_torch_cell_search.py::
# test_cell_search_matches_jax.
SIM_CAPTURES = [
    (dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10,
          freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3),
     np.arange(-3, 4) * 5e3),
    (dict(n_id_1=0, n_id_2=0, cp_type="normal", snr_db=10,
          freq_offset=-3.3e3, n_rb_dl=6, sfn_start=64, seed=3),
     np.arange(-3, 4) * 5e3),
    (dict(n_id_1=167, n_id_2=2, cp_type="extended", snr_db=10,
          freq_offset=11e3, n_rb_dl=100, sfn_start=64, seed=3),
     np.arange(-3, 4) * 5e3),
    (dict(n_id_1=30, n_id_2=2, cp_type="extended", snr_db=20.0,
          freq_offset=2e3, n_rb_dl=25, seed=3),
     np.arange(-2, 3) * 5e3),
]


@pytest.mark.parametrize("kw,fset", SIM_CAPTURES)
def test_3xtf32_peak_tables_match_plain(monkeypatch, kw, fset):
    """The peak tables of the 3xTF32 route equal the plain route's: lag,
    hypothesis and root exactly, powers within rtol 1e-5."""
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.ops.peak_torch import (
        peak_search_device, r_th1_normalized)

    cap = synthetic_capture(**kw)
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    tables = []
    for route in (xcorr_fold, _fold_3xtf32):
        monkeypatch.setattr(xcorr_torch, "xcorr_fold", route)
        packed, single, _ = xcorr_core(_cap2(cap), plan, 2)
        tables.append(peak_search_device(
            packed, single, r_th1_normalized(plan.n_comb_xc, 2), 2).numpy())
    want, got = tables
    assert (want[:, 0] > 0).sum() >= 1
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)


def _kernel_mirror(cap2, tpl, starts, n_comb_xc):
    """csrc/xcorr_fold.cu's formulation in torch: per fold and group of 8
    hypotheses (padded with zero templates), base = min starts, d_f =
    starts - base, W = 137 + max d_f rounded up to 4 taps; A[r][k] =
    X[2r + k] over the interleaved capture span X[2s + p] = cap_p[base + s]
    (0 outside the capture); B[2i + p][2c + q] the templates shifted by
    d_f, (q, p) = (0, 0) tr, (0, 1) -ti, (1, 0) ti, (1, 1) tr, 0 unless
    0 <= i - d_f < 137; C = A B, re = C[:, 2c], im = C[:, 2c + 1],
    |xc|^2 added fold by fold. Returns (3 * n_f, 9600)."""
    n_f, n_cap = tpl.shape[0], cap2.shape[1]
    n_g = -(-n_f // 8)
    tg = torch.zeros(8 * n_g, 3, 2, 137)
    tg[:n_f] = tpl
    tg = tg.view(n_g, 24, 2, 137)
    n = torch.arange(48)
    c, q = n // 2, n % 2
    out = torch.zeros(24 * n_g, 9600)
    for h in range(n_g):
        acc = torch.zeros(9600, 24)
        for m in range(n_comb_xc):
            st = starts[8 * h:8 * h + 8, m].long()
            base = int(st.min())
            d = torch.zeros(8, dtype=torch.long)
            d[:len(st)] = st - base
            w = (137 + int(d.max()) + 3) // 4 * 4
            s = base + torch.arange(9600 - 1 + w)
            ok = (s >= 0) & (s < n_cap)
            x = torch.zeros(2, len(s))
            x[:, ok] = cap2[:, s[ok]]
            a = x.T.reshape(-1).unfold(0, 2 * w, 2)       # (9600, 2W)
            k = torch.arange(2 * w)
            i, p = k // 2, k % 2
            ii = i[:, None] - d[c // 3][None, :]
            plane = p[:, None] ^ q[None, :]
            val = tg[h][c[None, :].expand_as(ii), plane, ii.clamp(0, 136)]
            sign = 1.0 - 2.0 * ((q[None, :] == 0) & (p[:, None] == 1))
            b = torch.where((ii >= 0) & (ii < 137), sign * val, 0.0)
            xc = a @ b                                     # (9600, 48)
            acc += xc[:, 0::2] ** 2 + xc[:, 1::2] ** 2
        out[24 * h:24 * h + 24] = (acc / n_comb_xc).T
    return out[:3 * n_f]


@pytest.mark.parametrize("n_cap,fset", [
    (48000, np.arange(-15, 16) * 5e3),
    (48000, np.arange(-8, 9) * 5e3),
    (48000, np.array([0.0])),
    (25000, np.arange(-120, 121) * 5e3),
    # Unsorted: the groups' fold starts spread wider than the grid's.
    (48000, np.random.default_rng(1).permutation(np.arange(-15, 16)) * 5e3),
], ids=["31", "17", "1", "241", "31-unsorted"])
def test_kernel_mirror_matches_plain(n_cap, fset):
    cap = _capture(n=n_cap, seed=7)
    plan = scan_plan(n_cap, fset, FC, FC, 1.92e6)
    args = (_cap2(cap), torch.from_numpy(plan.tpl),
            torch.from_numpy(plan.starts), plan.n_comb_xc)
    _close(_kernel_mirror(*args).numpy().astype(np.float64),
           xcorr_fold_plain(*args).numpy().astype(np.float64))


# ---- The Karatsuba kernel (K3) on the tensor cores, on the CPU.

def _kernel3_mirror(cap3, tpl, starts, n_comb_xc, bf16=False):
    """csrc/xcorr_fold.cu's K3 formulation in torch: the 3 n_f channels in
    groups of 16 (the last padded with zero templates); per fold and group,
    base = min starts over the group's hypotheses, d_f = starts - base, W =
    137 + max d_f rounded up to the mma depth (8 taps for TF32, 16 for
    bf16); per plane p (a, b, a+b against tr, ti, tr+ti) M_p = T_p X_p with
    T_p[c][k] = tpl_p[c][k - d_f(c)], 0 unless 0 <= k - d_f < 137, and the
    Toeplitz X_p[k][l] = x_p[base + l + k] (0 outside the capture), read
    from the pair words the kernel stages: X[k0 + t (+ 4)][l] = Y[l + k0 +
    t] = (x[s], x[s + 4]) for TF32 (k0 a multiple of 8, t < 4), X[k0 + 2t
    (+ 1, + 8, + 9)][l] = Q[l + k0 + 2t] = (x[s], x[s + 1], x[s + 8],
    x[s + 9]) for bf16 (k0 a multiple of 16); then re = m1 - m2,
    im = (m3 - m1) - m2 and |xc|^2 added fold by fold. Returns
    (3 * n_f, 9600)."""
    n_f, n_cap = tpl.shape[0], cap3.shape[1]
    n_ch = 3 * n_f
    n_g, depth = -(-n_ch // 16), 16 if bf16 else 8
    tg = torch.zeros(16 * n_g, 3, 137)
    tg[:n_ch] = tpl.float().reshape(n_ch, 3, 137)
    # The pair words' members: offset of each within its word, and the
    # k (mod the depth) each X row takes from word l + k - member.
    members = [0, 1, 8, 9] if bf16 else [0, 4]
    k_idx = torch.arange(depth)
    if bf16:      # k = 2t + e: word at 2t, member e in 0, 1, 8, 9
        word_off = 2 * ((k_idx % 8) // 2)
        member = (k_idx % 2) + 2 * (k_idx // 8)
    else:         # k = t + 4h: word at t, member h
        word_off, member = k_idx % 4, k_idx // 4
    out = torch.zeros(16 * n_g, 9600)
    for grp in range(n_g):
        rows = torch.arange(16 * grp, 16 * grp + 16)
        h0, h1 = 16 * grp // 3, (min(16 * grp + 16, n_ch) - 1) // 3
        acc = torch.zeros(16, 9600)
        for m in range(n_comb_xc):
            st = starts[h0:h1 + 1, m].long()
            base = int(st.min())
            hyp = (rows // 3).clamp(max=h1)
            d = torch.where(rows < n_ch, starts[hyp, m].long() - base, 0)
            w = (137 + int(st.max()) - base + depth - 1) // depth * depth
            s = base + torch.arange(9600 + w + 9)
            ok = (s >= 0) & (s < n_cap)
            x = torch.zeros(3, len(s))
            x[:, ok] = cap3[:, s[ok]].float()
            # The staged pair words: word l holds x[l + member].
            words = torch.stack([x[:, mb:mb + 9600 + w] for mb in members],
                                -1)
            k = torch.arange(w)
            wo, mb = word_off[k % depth] + k - k % depth, member[k % depth]
            lags = torch.arange(9600)
            xk = words[:, lags[None, :] + wo[:, None], mb[:, None]]
            ii = k[None, :] - d[:, None]                     # (16, W)
            tk = torch.where(((ii >= 0) & (ii < 137))[..., None],
                             tg[rows[:, None], :, ii.clamp(0, 136)], 0.0)
            m1, m2, m3 = (tk[..., p] @ xk[p] for p in range(3))
            re = m1 - m2
            im = (m3 - m1) - m2
            acc += re ** 2 + im ** 2
        out[rows] = acc / n_comb_xc
    return out[:n_ch]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_cap,fset", [
    (48000, np.arange(-15, 16) * 5e3),
    (48000, np.arange(-8, 9) * 5e3),
    (48000, np.array([0.0])),
    (25000, np.arange(-120, 121) * 5e3),
    # Unsorted: the groups' fold starts spread wider than the grid's.
    (48000, np.random.default_rng(1).permutation(np.arange(-15, 16)) * 5e3),
], ids=["31", "17", "1", "241", "31-unsorted"])
def test_kernel3_mirror_matches_plain(n_cap, fset, precision):
    """K3's formulation in both modes against its plain version; in bf16
    on the bf16-rounded planes and bank that xcorr_core hands it."""
    cap = _capture(n=n_cap, seed=7)
    plan = scan_plan(n_cap, fset, FC, FC, 1.92e6, layout="tea3",
                     precision=precision)
    cap3, tpl = karatsuba_inputs(_cap2(cap), torch.from_numpy(plan.tpl),
                                 precision)
    args = (cap3, tpl, torch.from_numpy(plan.starts), plan.n_comb_xc)
    _close(_kernel3_mirror(*args, bf16=precision == "bf16").numpy()
           .astype(np.float64),
           xcorr_fold3_plain(*args).numpy().astype(np.float64))


def test_3xtf32_karatsuba_error_near_float32():
    """The float32 K3's products (three TF32-split convolutions per plane,
    the dropped lo*lo terms included) summed in float32, against a float64
    reference: no more than twice the error of plain float32 Karatsuba."""
    cap = _capture(seed=5)
    fset = np.arange(-15, 16) * 5e3
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6, layout="tea3")
    cap3, tpl = karatsuba_planes(_cap2(cap)), torch.from_numpy(plan.tpl)
    starts = torch.from_numpy(plan.starts)
    ref = xcorr_fold3_plain(cap3.double(), tpl.double(), starts,
                            plan.n_comb_xc)
    err_f32 = (xcorr_fold3_plain(cap3, tpl, starts, plan.n_comb_xc).double()
               - ref).abs().max()
    err_split = (xcorr_fold3_3xtf32_plain(cap3, tpl, starts, plan.n_comb_xc
                                          ).double() - ref).abs().max()
    assert 0 < err_f32 < 1e-5 * ref.abs().max()
    assert err_split <= 2 * err_f32


def test_fold3_mode_by_dtype():
    """xcorr_fold3 runs the float32 or the bf16 mode by its inputs' dtype:
    the bf16 cast of xcorr_core's inputs is exact, the bf16 mode gives the
    float32 mode's result on the same rounded values, and a mixed or other
    dtype raises."""
    cap = _capture(n=25000, seed=3)
    fset = np.arange(-2, 3) * 5e3
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6, layout="tea3",
                     precision="bf16")
    tpl32 = torch.from_numpy(plan.tpl)
    cap3, tpl = karatsuba_inputs(_cap2(cap), tpl32, "bf16")
    assert cap3.dtype == tpl.dtype == torch.bfloat16
    cap3_32 = karatsuba_planes(_cap2(cap), "bf16")
    assert torch.equal(cap3.float(), cap3_32)
    assert torch.equal(tpl.float(), tpl32)
    starts = torch.from_numpy(plan.starts)
    assert torch.equal(xcorr_fold3(cap3, tpl, starts, plan.n_comb_xc),
                       xcorr_fold3(cap3_32, tpl32, starts, plan.n_comb_xc))
    for a, b in ((cap3, tpl32), (cap3_32, tpl),
                 (cap3_32.double(), tpl32.double())):
        with pytest.raises(ValueError):
            xcorr_fold3(a, b, starts, plan.n_comb_xc)
