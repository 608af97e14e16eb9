"""PSS hypothesis scan on the device: correlation bank + k_factor fold
(the ``xcorr_fold`` CUDA kernel), delay spread, signal power and the
frequency collapse.

Counterpart of lte_cell_scanner_tpu/ops/xcorr_pallas.py
(``xcorr_core_pallas``) and ops/xcorr_jax.py (``_delay_spread``,
``win_sum``, ``_sp_est_from_pw``), with the same
``(packed (7, 9600), single (3, 9600, n_f), inc)`` contract: packed rows
0-2 are the collapsed peak powers, rows 3-5 the argmax hypothesis indices
(as floats), row 6 the folded signal power.

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


@dataclasses.dataclass
class ScanPlan:
    """Host-planned inputs of the scan for one capture length and grid."""

    tpl: np.ndarray       # (n_f, 3, 2, 137) f32 re/im of the templates
    starts: np.ndarray    # (n_f, n_comb_xc) i32 fold start lags
    n_comb_xc: int
    n_comb_sp: int


def scan_plan(n_cap: int, f_search_set, fc_requested: float,
              fc_programmed: float, fs_programmed: float) -> ScanPlan:
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    n_comb_xc = n_comb_xc_for(n_cap - (PSS_TD_LEN - 1), f_search_set,
                              fc_requested, fc_programmed, fs_programmed)
    tpl = shifted_templates(f_search_set, fc_requested, fc_programmed,
                            fs_programmed)                   # (n_f, 3, 137)
    starts = fold_start_indices(f_search_set, n_comb_xc, fc_requested,
                                fc_programmed, fs_programmed)
    return ScanPlan(
        tpl=np.stack([tpl.real, tpl.imag], axis=2).astype(np.float32),
        starts=starts.astype(np.int32),
        n_comb_xc=int(n_comb_xc),
        n_comb_sp=int(n_comb_sp_for(n_cap)))


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
    n_f = tpl.shape[0]
    n_ch = 3 * n_f
    w_re = tpl[:, :, 0].reshape(n_ch, PSS_TD_LEN)
    w_im = tpl[:, :, 1].reshape(n_ch, PSS_TD_LEN)
    weight = torch.cat([torch.stack([w_re, -w_im], 1),
                        torch.stack([w_im, w_re], 1)], 0)
    xc = F.conv1d(cap2[None], weight)[0]                  # (2*n_ch, n_lags)
    mag = (xc[:n_ch] ** 2 + xc[n_ch:] ** 2).view(n_f, 3, -1)
    lags = torch.arange(HALF_FRAME, device=cap2.device)
    acc = None
    for m in range(n_comb_xc):
        idx = (starts[:, m, None].long() + lags)[:, None, :].expand(
            n_f, 3, HALF_FRAME)
        part = torch.gather(mag, 2, idx)
        acc = part if acc is None else acc + part
    return (acc / n_comb_xc).reshape(n_ch, HALF_FRAME)


def xcorr_fold(cap2: torch.Tensor, tpl: torch.Tensor, starts: torch.Tensor,
               n_comb_xc: int) -> torch.Tensor:
    """Fused correlation + incoherent fold.

    cap2 (2, n_cap) f32 re/im planes; tpl (n_f, 3, 2, 137) f32; starts
    (n_f, n_comb_xc) i32 with every fold window inside the capture
    (n_comb_xc_for). Returns single (3, 9600, n_f) f32, the
    ``xc_incoherent_single`` of the reference. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel.
    """
    n_f = tpl.shape[0]
    if cap2.device.type == "cpu":
        fold = xcorr_fold_plain(cap2, tpl, starts, n_comb_xc)
    else:
        _check(cap2, torch.float32, 2, "cap2")
        _check(tpl, torch.float32, 4, "tpl")
        _check(starts, torch.int32, 2, "starts")
        if cap2.shape[0] != 2 or tpl.shape[1:] != (3, 2, PSS_TD_LEN) \
                or starts.shape != (n_f, n_comb_xc):
            raise ValueError("xcorr_fold: bad shapes "
                             f"{tuple(cap2.shape)} {tuple(tpl.shape)} "
                             f"{tuple(starts.shape)}")
        if not (cap2.device == tpl.device == starts.device):
            raise ValueError("xcorr_fold: tensors on different devices")
        fold = torch.empty((3 * n_f, HALF_FRAME), dtype=torch.float32,
                           device=cap2.device)
        code = launcher("xcorr_fold")(
            cap2.data_ptr(), cap2.shape[1], tpl.data_ptr(),
            starts.data_ptr(), n_f, n_comb_xc, fold.data_ptr(),
            torch.cuda.current_stream(cap2.device).cuda_stream)
        check_launch("xcorr_fold", code)
        LAUNCHES["xcorr_fold"] += 1
    return fold.view(n_f, 3, HALF_FRAME).permute(1, 2, 0)


def _check(t: torch.Tensor, dtype, ndim: int, name: str) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-D {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _delay_spread(single: torch.Tensor, ds_comb_arm: int) -> torch.Tensor:
    out = single
    for t in range(1, ds_comb_arm + 1):
        out = out + torch.roll(single, t, 1) + torch.roll(single, -t, 1)
    return out / (2 * ds_comb_arm + 1)


def win_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Sliding w-window sum by length doubling: S_{a+b}[k] = S_a[k] +
    S_b[k+a], the balanced tree of the JAX scan (a cumsum difference
    would lose float32 accuracy over 150k samples)."""
    memo = {1: x}

    def s(n):
        if n not in memo:
            h = n // 2
            a, b = s(h), s(n - h)
            ln = x.shape[0] - n + 1
            memo[n] = a[:ln] + b[h:h + ln]
        return memo[n]

    return s(w)


def _sp_est_from_pw(pw: torch.Tensor, n_comb_sp: int) -> torch.Tensor:
    """Sliding 274-sample mean power folded into one half-frame, rolled
    by 137 to align with the correlation peaks."""
    n_sp = n_comb_sp * HALF_FRAME
    sp = (win_sum(pw, 2 * PSS_TD_LEN)[:n_sp] / 274.0).view(
        n_comb_sp, HALF_FRAME)
    acc = sp[0]
    for i in range(1, n_comb_sp):
        acc = acc + sp[i]
    return torch.roll(acc / n_comb_sp, PSS_TD_LEN)


def xcorr_core(cap2: torch.Tensor, plan: ScanPlan, ds_comb_arm: int):
    """Full scan of one capture. cap2 (2, n_cap) f32 on the device.

    Returns (packed (7, 9600), single (3, 9600, n_f), inc (3, 9600, n_f)).
    """
    dev = cap2.device
    single = xcorr_fold(cap2, torch.from_numpy(plan.tpl).to(dev),
                        torch.from_numpy(plan.starts).to(dev),
                        plan.n_comb_xc)
    inc = _delay_spread(single, ds_comb_arm)
    sp_inc = _sp_est_from_pw(cap2[0] ** 2 + cap2[1] ** 2, plan.n_comb_sp)
    pow_ = inc.amax(dim=2)
    frq = inc.argmax(dim=2).to(pow_.dtype)
    packed = torch.cat([pow_, frq, sp_inc[None]], dim=0)
    return packed, single, inc
