"""PSS hypothesis scan on the device: correlation bank + k_factor fold
(the ``xcorr_fold``, ``xcorr_fold3`` and ``xcorr_fold3_bf16`` CUDA
kernels), delay spread, signal power and the frequency collapse.

Counterpart of lte_cell_scanner_tpu/ops/xcorr_pallas.py
(``xcorr_core_pallas``) and ops/xcorr_jax.py (``_delay_spread``,
``win_sum``, ``_sp_est_from_pw``), with the same
``(packed (7, 9600), single (3, 9600, n_f), inc)`` contract: packed rows
0-2 are the collapsed peak powers, rows 3-5 the argmax hypothesis indices
(as floats), row 6 the folded signal power.

Layouts (:func:`scan_plan`): "tea" and "roll" name the JAX package's two
2x2 real-block kernels (K1, K2); one CUDA kernel, ``xcorr_fold``, serves
both, on the tensor cores with 3xTF32 products (each operand split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, :func:`tf32_round`; the sum
``lo*hi + hi*lo + hi*hi`` keeps the error near float32's;
:func:`xcorr_fold_3xtf32_plain` models the products). "tea3" is the
Karatsuba kernel (K3): three real products per tap on the tensor cores,
``xcorr_fold3`` in two modes picked by the inputs' dtype: float32 runs
3xTF32 products (:func:`xcorr_fold3_3xtf32_plain` models them), bfloat16
one bf16 product per tap with float32 sums. Precision "bf16" reproduces
the JAX bf16 mode's rounding points (the template bank, the window values
and, for tea3, the sum re+im, each rounded to bfloat16): K1 then runs on
the rounded float32 values (a bf16 value is exact in TF32, so the split's
low parts are zero), K3 in its bf16 mode (:func:`karatsuba_inputs`).

All k_factor-dependent index arithmetic (template shifts, fold starts) is
float64 host planning in :func:`scan_plan`; the device works in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from lte_cell_scanner_tpu_torch.constants import HALF_FRAME, PSS_TD_LEN
from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
from lte_cell_scanner_tpu_torch.kernels.build import check_launch, launcher
from lte_cell_scanner_tpu_torch.ops.xcorr import (fold_start_indices,
                                                  n_comb_sp_for,
                                                  n_comb_xc_for,
                                                  shifted_templates)
from lte_cell_scanner_tpu_torch.utils.device import launch_device

LAYOUTS = ("tea", "roll", "tea3")
PRECISIONS = ("f32", "bf16")


@dataclasses.dataclass
class ScanPlan:
    """Host-planned inputs of the scan for one capture length and grid."""

    tpl: np.ndarray       # (n_f, 3, P, 137) f32 template planes: re, im
                          # (P = 2) or re, im, re+im (P = 3, layout tea3)
    starts: np.ndarray    # (n_f, n_comb_xc) i32 fold start lags
    n_comb_xc: int
    n_comb_sp: int
    layout: str = "tea"
    precision: str = "f32"


def round_bf16(x):
    """Round float32 values to the nearest bfloat16 (ties to even), kept
    in float32: a numpy array or a tensor, returned as the same kind."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x.to(torch.bfloat16).float()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (a 10-bit mantissa), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does; kept in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def scan_plan(n_cap: int, f_search_set, fc_requested: float,
              fc_programmed: float, fs_programmed: float,
              layout: str = "tea", precision: str = "f32") -> ScanPlan:
    if layout not in LAYOUTS or precision not in PRECISIONS:
        raise ValueError(f"scan_plan: layout {layout!r} not in {LAYOUTS} or "
                         f"precision {precision!r} not in {PRECISIONS}")
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    n_comb_xc = n_comb_xc_for(n_cap - (PSS_TD_LEN - 1), f_search_set,
                              fc_requested, fc_programmed, fs_programmed)
    tpl = shifted_templates(f_search_set, fc_requested, fc_programmed,
                            fs_programmed)                   # (n_f, 3, 137)
    starts = fold_start_indices(f_search_set, n_comb_xc, fc_requested,
                                fc_programmed, fs_programmed)
    planes = [tpl.real, tpl.imag]
    if layout == "tea3":
        # The Karatsuba bank's third plane, summed in float64 as the JAX
        # package's _tea_bank3 does, then rounded once.
        planes.append(tpl.real + tpl.imag)
    bank = np.stack(planes, axis=2).astype(np.float32)
    if precision == "bf16":
        bank = round_bf16(bank)
    return ScanPlan(tpl=bank, starts=starts.astype(np.int32),
                    n_comb_xc=int(n_comb_xc),
                    n_comb_sp=int(n_comb_sp_for(n_cap)),
                    layout=layout, precision=precision)


def karatsuba_planes(cap2: torch.Tensor, precision: str = "f32"
                     ) -> torch.Tensor:
    """(2, n_cap) re/im -> (3, n_cap) re, im, re+im: the capture planes of
    ``xcorr_fold3``. In bf16 each plane is rounded, the sum after the add
    of the unrounded f32 values (the JAX tea3 kernel's rounding points)."""
    cap3 = torch.cat([cap2, (cap2[0] + cap2[1])[None]])
    return round_bf16(cap3) if precision == "bf16" else cap3


def xcorr_fold_plain(cap2: torch.Tensor, tpl: torch.Tensor,
                     starts: torch.Tensor, n_comb_xc: int,
                     chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of the ``xcorr_fold`` kernel: (n_f*3, 9600).

    The complex correlation of the templates is one real 2-channel
    convolution ([[re, -im], [im, re]] blocks); the fold adds the
    hypothesis-aligned |xc|^2 slices in ascending fold order. Hypotheses
    go ``chunk`` at a time to bound the (6*chunk, n_lags) correlation."""
    return torch.cat([
        _fold_plain_chunk(cap2, tpl[i:i + chunk], starts[i:i + chunk],
                          n_comb_xc)
        for i in range(0, tpl.shape[0], chunk)])


def _fold_plain_chunk(cap2, tpl, starts, n_comb_xc):
    n_ch = 3 * tpl.shape[0]
    xc = F.conv1d(cap2[None], _block_weight(tpl))[0]      # (2*n_ch, n_lags)
    return _fold(xc[:n_ch] ** 2 + xc[n_ch:] ** 2, starts, n_comb_xc)


def _block_weight(tpl):
    """(n_f, 3, 2, 137) -> (6 n_f, 2, 137): the [[re, -im], [im, re]]
    blocks of the complex correlation as a real 2-channel convolution."""
    n_ch = 3 * tpl.shape[0]
    w_re = tpl[:, :, 0].reshape(n_ch, PSS_TD_LEN)
    w_im = tpl[:, :, 1].reshape(n_ch, PSS_TD_LEN)
    return torch.cat([torch.stack([w_re, -w_im], 1),
                      torch.stack([w_im, w_re], 1)], 0)


def xcorr_fold_3xtf32_plain(cap2: torch.Tensor, tpl: torch.Tensor,
                            starts: torch.Tensor, n_comb_xc: int
                            ) -> torch.Tensor:
    """The ``xcorr_fold`` kernel's products in plain PyTorch: (n_f*3, 9600).

    The capture and the 2x2 real-block templates split into TF32 hi and lo
    (:func:`tf32_round`), then three float32 convolutions lo*hi + hi*lo +
    hi*hi, then |xc|^2 and the fold. A TF32 x TF32 product is exact in
    float32, so this differs from the kernel only in its sums (their
    order, and float32's rounding here against the tensor cores' there):
    it tells the split's error apart from the accumulation's. On the
    card, call it with float32 convolutions in full float32
    (``full_f32_matmuls``)."""
    n_ch = 3 * tpl.shape[0]

    def split(x):
        hi = tf32_round(x)
        return hi, tf32_round(x - hi)

    (x_hi, x_lo), (w_hi, w_lo) = split(cap2[None]), split(_block_weight(tpl))
    xc = (F.conv1d(x_lo, w_hi) + F.conv1d(x_hi, w_lo)
          + F.conv1d(x_hi, w_hi))[0]
    return _fold(xc[:n_ch] ** 2 + xc[n_ch:] ** 2, starts, n_comb_xc)


def _fold(mag, starts, n_comb_xc):
    """(n_ch, n_lags) |xc|^2 -> (n_ch, 9600): the hypothesis-aligned
    slices added in ascending fold order, over n_comb_xc."""
    n_f = starts.shape[0]
    mag = mag.view(n_f, 3, -1)
    lags = torch.arange(HALF_FRAME, device=mag.device)
    acc = None
    for m in range(n_comb_xc):
        idx = (starts[:, m, None].long() + lags)[:, None, :].expand(
            n_f, 3, HALF_FRAME)
        part = torch.gather(mag, 2, idx)
        acc = part if acc is None else acc + part
    return (acc / n_comb_xc).reshape(3 * n_f, HALF_FRAME)


def xcorr_fold(cap2: torch.Tensor, tpl: torch.Tensor, starts: torch.Tensor,
               n_comb_xc: int) -> torch.Tensor:
    """Fused correlation + incoherent fold.

    cap2 (2, n_cap) f32 re/im planes; tpl (n_f, 3, 2, 137) f32; starts
    (n_f, n_comb_xc) i32 with every fold window inside the capture
    (n_comb_xc_for). Returns single (3, 9600, n_f) f32, the
    ``xc_incoherent_single`` of the reference. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (one capture of
    :func:`xcorr_fold_batch`'s launch).
    """
    if cap2.device.type == "cpu":
        n_f = tpl.shape[0]
        return xcorr_fold_plain(cap2, tpl, starts, n_comb_xc).view(
            n_f, 3, HALF_FRAME).permute(1, 2, 0)
    return _fold_batch_launch(cap2[None], tpl[None], None, starts[None],
                              n_comb_xc)[0]


def xcorr_fold_batch_plain(cap: torch.Tensor, tpl_bank: torch.Tensor,
                           bank_idx: torch.Tensor, starts: torch.Tensor,
                           n_comb_xc: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`xcorr_fold_batch`: a loop of
    :func:`xcorr_fold_plain` over the captures. Returns (B, 3, 9600, n_f)."""
    n_f = tpl_bank.shape[1]
    return torch.stack([
        xcorr_fold_plain(cap[b], tpl_bank[int(bank_idx[b])], starts[b],
                         n_comb_xc).view(n_f, 3, HALF_FRAME).permute(1, 2, 0)
        for b in range(cap.shape[0])])


def xcorr_fold_batch(cap: torch.Tensor, tpl_bank: torch.Tensor,
                     bank_idx: torch.Tensor, starts: torch.Tensor,
                     n_comb_xc: int) -> torch.Tensor:
    """Fused correlation + incoherent fold of a stack of B captures, in one
    launch of the ``xcorr_fold`` kernel.

    cap (B, 2, n_cap) f32 re/im planes; tpl_bank (n_bank, n_f, 3, 2, 137)
    f32; bank_idx (B,) i32, the bank of each capture, in [0, n_bank) (on
    the card an index outside it gives that capture NaN, without a read;
    checking it here would wait for the card); starts (B, n_f, n_comb_xc)
    i32, every fold window inside its capture. Returns (B, 3, 9600, n_f)
    f32. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if cap.device.type == "cpu":
        return xcorr_fold_batch_plain(cap, tpl_bank, bank_idx, starts,
                                      n_comb_xc)
    _check(bank_idx, torch.int32, 1, "bank_idx")
    if bank_idx.shape[0] != cap.shape[0] or bank_idx.device != cap.device:
        raise ValueError(f"xcorr_fold_batch: want bank_idx ({cap.shape[0]},)"
                         f" on {cap.device}, got {tuple(bank_idx.shape)} on "
                         f"{bank_idx.device}")
    return _fold_batch_launch(cap, tpl_bank, bank_idx, starts, n_comb_xc)


def _fold_batch_launch(cap, tpl_bank, bank_idx, starts, n_comb_xc):
    """Check the arguments of the ``xcorr_fold`` kernel and launch it over
    the B captures; returns (B, 3, 9600, n_f) f32."""
    name = "xcorr_fold"
    _check(cap, torch.float32, 3, "cap")
    _check(tpl_bank, torch.float32, 5, "tpl")
    _check(starts, torch.int32, 3, "starts")
    B, n_f = cap.shape[0], tpl_bank.shape[1]
    if cap.shape[1] != 2 or tpl_bank.shape[2:] != (3, 2, PSS_TD_LEN) \
            or starts.shape != (B, n_f, n_comb_xc):
        raise ValueError(f"{name}: bad shapes {tuple(cap.shape)} "
                         f"{tuple(tpl_bank.shape)} {tuple(starts.shape)}")
    if not (cap.device == tpl_bank.device == starts.device):
        raise ValueError(f"{name}: tensors on different devices")
    fold = torch.empty((B, 3 * n_f, HALF_FRAME), dtype=torch.float32,
                       device=cap.device)
    # The C launcher launches on the runtime's current device.
    with launch_device(cap.device):
        code = launcher(name)(
            cap.data_ptr(), cap.shape[2], tpl_bank.data_ptr(),
            tpl_bank.shape[0],
            None if bank_idx is None else bank_idx.data_ptr(),
            starts.data_ptr(), n_f, n_comb_xc, B, fold.data_ptr(),
            torch.cuda.current_stream(cap.device).cuda_stream)
    check_launch(name, code)
    LAUNCHES[name] += 1
    return fold.view(B, n_f, 3, HALF_FRAME).permute(0, 2, 3, 1)


def _fold_call(name, dtype, cap, tpl, starts, n_comb_xc):
    """Run K3's kernel ``name`` (3 capture and template planes of
    ``dtype``), or its plain version for a CPU tensor; returns
    (3, 9600, n_f) f32."""
    n_f = tpl.shape[0]
    if cap.device.type == "cpu":
        fold = xcorr_fold3_plain(cap, tpl, starts, n_comb_xc)
    else:
        _check(cap, dtype, 2, "cap")
        _check(tpl, dtype, 4, "tpl")
        _check(starts, torch.int32, 2, "starts")
        if cap.shape[0] != 3 or tpl.shape[1:] != (3, 3, PSS_TD_LEN) \
                or starts.shape != (n_f, n_comb_xc):
            raise ValueError(f"{name}: bad shapes {tuple(cap.shape)} "
                             f"{tuple(tpl.shape)} {tuple(starts.shape)}")
        if not (cap.device == tpl.device == starts.device):
            raise ValueError(f"{name}: tensors on different devices")
        fold = torch.empty((3 * n_f, HALF_FRAME), dtype=torch.float32,
                           device=cap.device)
        # The C launcher launches on the runtime's current device.
        with launch_device(cap.device):
            code = launcher(name)(
                cap.data_ptr(), cap.shape[1], tpl.data_ptr(),
                starts.data_ptr(), n_f, n_comb_xc, fold.data_ptr(),
                torch.cuda.current_stream(cap.device).cuda_stream)
        check_launch(name, code)
        LAUNCHES[name] += 1
    return fold.view(n_f, 3, HALF_FRAME).permute(1, 2, 0)


def xcorr_fold3_plain(cap3: torch.Tensor, tpl: torch.Tensor,
                      starts: torch.Tensor, n_comb_xc: int,
                      chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version of the ``xcorr_fold3`` kernel, both modes:
    (n_f*3, 9600) f32.

    Three real correlations per channel, k1 = tr * a, k2 = ti * b,
    k3 = (tr+ti) * (a+b), recombined as re = k1 - k2, im = (k3 - k1) - k2;
    then the fold of :func:`xcorr_fold_plain`. bfloat16 inputs (the bf16
    mode) are widened to float32, which is exact, and their products are
    exact in float32, as in the kernel."""
    if cap3.dtype == torch.bfloat16:
        cap3, tpl = cap3.float(), tpl.float()
    return torch.cat([
        _fold3_plain_chunk(cap3, tpl[i:i + chunk], starts[i:i + chunk],
                           n_comb_xc)
        for i in range(0, tpl.shape[0], chunk)])


def _fold3_plain_chunk(cap3, tpl, starts, n_comb_xc, conv=F.conv1d):
    n_f = tpl.shape[0]
    w = tpl.reshape(3 * n_f, 3, PSS_TD_LEN)
    k1, k2, k3 = (conv(cap3[None, p:p + 1], w[:, p:p + 1])[0]
                  for p in range(3))                      # (n_ch, n_lags)
    re = k1 - k2
    im = (k3 - k1) - k2
    return _fold(re ** 2 + im ** 2, starts, n_comb_xc)


def xcorr_fold3_3xtf32_plain(cap3: torch.Tensor, tpl: torch.Tensor,
                             starts: torch.Tensor, n_comb_xc: int
                             ) -> torch.Tensor:
    """The float32 ``xcorr_fold3`` kernel's products in plain PyTorch:
    (n_f*3, 9600).

    Each of the three real correlations as three float32 convolutions of
    the TF32-split planes, lo*hi + hi*lo + hi*hi (as
    :func:`xcorr_fold_3xtf32_plain` does for the 2x2 kernel), then the
    Karatsuba recombination and the fold. On the card, call it with
    float32 convolutions in full float32 (``full_f32_matmuls``)."""
    def split(x):
        hi = tf32_round(x)
        return hi, tf32_round(x - hi)

    def conv(x, w):
        (x_hi, x_lo), (w_hi, w_lo) = split(x), split(w)
        return (F.conv1d(x_lo, w_hi) + F.conv1d(x_hi, w_lo)
                + F.conv1d(x_hi, w_hi))

    return _fold3_plain_chunk(cap3, tpl, starts, n_comb_xc, conv)


def xcorr_fold3(cap3: torch.Tensor, tpl: torch.Tensor, starts: torch.Tensor,
                n_comb_xc: int) -> torch.Tensor:
    """Fused Karatsuba correlation + incoherent fold (layout "tea3").

    cap3 (3, n_cap) planes re, im, re+im (:func:`karatsuba_planes`); tpl
    (n_f, 3, 3, 137) planes re, im, re+im (``scan_plan(...,
    layout="tea3").tpl``); starts (n_f, n_comb_xc) i32 with every fold
    window inside the capture. The dtype picks the kernel: float32 planes
    and bank run ``xcorr_fold3`` (3xTF32 products), bfloat16 planes and
    bank run ``xcorr_fold3_bf16`` (one bf16 product, float32 sums); any
    other pair raises. Returns single (3, 9600, n_f) f32. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel.
    """
    if cap3.dtype != tpl.dtype \
            or cap3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xcorr_fold3: want float32 or bfloat16 planes and "
                         f"bank of one dtype, got {cap3.dtype} and "
                         f"{tpl.dtype}")
    name = "xcorr_fold3_bf16" if cap3.dtype == torch.bfloat16 \
        else "xcorr_fold3"
    return _fold_call(name, cap3.dtype, cap3, tpl, starts, n_comb_xc)


def karatsuba_inputs(cap2: torch.Tensor, tpl: torch.Tensor,
                     precision: str = "f32"):
    """The inputs of ``xcorr_fold3`` as :func:`xcorr_core` hands them:
    (cap3, tpl) in float32, or in bfloat16 for precision "bf16", where
    :func:`karatsuba_planes` and :func:`scan_plan` have already rounded
    every value to bfloat16, so the cast is exact."""
    cap3 = karatsuba_planes(cap2, precision)
    if precision == "bf16":
        return cap3.to(torch.bfloat16), tpl.to(torch.bfloat16)
    return cap3, tpl


def _check(t: torch.Tensor, dtype, ndim: int, name: str) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-D {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _delay_spread(single: torch.Tensor, ds_comb_arm: int) -> torch.Tensor:
    """Mean over +-ds_comb_arm cyclic lags; the lag axis is -2 of
    (..., 9600, n_f)."""
    out = single
    for t in range(1, ds_comb_arm + 1):
        out = out + torch.roll(single, t, -2) + torch.roll(single, -t, -2)
    return out / (2 * ds_comb_arm + 1)


def win_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding w-window sum along the last axis by length doubling:
    S_{a+b}[k] = S_a[k] + S_b[k+a], the balanced tree of the JAX scan (a
    cumsum difference would lose float32 accuracy over 150k samples)."""
    memo = {1: x}

    def s(n):
        if n not in memo:
            h = n // 2
            a, b = s(h), s(n - h)
            ln = x.shape[-1] - n + 1
            memo[n] = a[..., :ln] + b[..., h:h + ln]
        return memo[n]

    return s(w)


def _sp_est_from_pw(pw: torch.Tensor, n_comb_sp: int) -> torch.Tensor:
    """Sliding 274-sample mean power folded into one half-frame, rolled
    by 137 to align with the correlation peaks: (..., n_cap) ->
    (..., 9600)."""
    n_sp = n_comb_sp * HALF_FRAME
    sp = (win_sum(pw, 2 * PSS_TD_LEN)[..., :n_sp] / 274.0).reshape(
        *pw.shape[:-1], n_comb_sp, HALF_FRAME)
    acc = sp[..., 0, :]
    for i in range(1, n_comb_sp):
        acc = acc + sp[..., i, :]
    return torch.roll(acc / n_comb_sp, PSS_TD_LEN, -1)


def _collapse(single, cap2, ds_comb_arm, n_comb_sp):
    """Delay spread, signal power and the frequency collapse of one scan or
    of a stack: single (..., 3, 9600, n_f), cap2 (..., 2, n_cap) ->
    (packed (..., 7, 9600), inc)."""
    inc = _delay_spread(single, ds_comb_arm)
    sp_inc = _sp_est_from_pw(cap2[..., 0, :] ** 2 + cap2[..., 1, :] ** 2,
                             n_comb_sp)
    pow_ = inc.amax(dim=-1)
    frq = inc.argmax(dim=-1).to(pow_.dtype)
    return torch.cat([pow_, frq, sp_inc[..., None, :]], dim=-2), inc


def xcorr_core(cap2: torch.Tensor, plan: ScanPlan, ds_comb_arm: int):
    """Full scan of one capture. cap2 (2, n_cap) f32 on the device.

    ``plan.layout`` picks the kernel ("tea"/"roll": ``xcorr_fold``,
    "tea3": ``xcorr_fold3``); ``plan.precision`` "bf16" rounds the
    correlation's inputs (the signal power uses the f32 capture) and runs
    K3 in its bf16 mode.
    Returns (packed (7, 9600), single (3, 9600, n_f), inc (3, 9600, n_f)).
    """
    dev = cap2.device
    tpl = torch.from_numpy(plan.tpl).to(dev)
    starts = torch.from_numpy(plan.starts).to(dev)
    if plan.layout == "tea3":
        single = xcorr_fold3(*karatsuba_inputs(cap2, tpl, plan.precision),
                             starts, plan.n_comb_xc)
    else:
        cap_x = round_bf16(cap2) if plan.precision == "bf16" else cap2
        single = xcorr_fold(cap_x, tpl, starts, plan.n_comb_xc)
    packed, inc = _collapse(single, cap2, ds_comb_arm, plan.n_comb_sp)
    return packed, single, inc


def xcorr_core_batch(cap: torch.Tensor, tpl_bank: torch.Tensor,
                     bank_idx: torch.Tensor, starts: torch.Tensor,
                     n_comb_xc: int, n_comb_sp: int, ds_comb_arm: int):
    """Full scan of a stack of B captures (layout "tea", float32): one
    :func:`xcorr_fold_batch` launch, then delay spread, signal power and
    the collapse over the leading axis. Arguments as
    :func:`xcorr_fold_batch`. Returns (packed (B, 7, 9600), single
    (B, 3, 9600, n_f))."""
    single = xcorr_fold_batch(cap, tpl_bank, bank_idx, starts, n_comb_xc)
    packed, _ = _collapse(single, cap, ds_comb_arm, n_comb_sp)
    return packed, single
