"""Fused OFDM symbol demodulation of the MIB chain (the ``fd_demod`` CUDA
kernel) and its plain PyTorch version.

Counterpart of lte_cell_scanner_tpu/ops/fd_demod_pallas.py in its MIB
mode (f32 samples, ``pre_bpo=True``, the 128->72 DFT of
ops/mib_torch.py::_dft72). For the window at sample ``idx``, with
a = idx // 128 and b = idx % 128:

  g[c]   = row a at lanes c >= b, row a+1 below    (cyclic blend)
  j[c]   = c - b + 128*(c < b)                     (true sample index)
  x      = g * exp(i*(bpo + foc*j))                (FOC + bulk phase)
  y      = x @ (wr + i*wi)                         (128 -> 72 bins)
  out    = y * exp(-i*2*pi*(late - b)*cn/128)      (timing ramp)

The kernel gathers the two 128-aligned rows itself, with the zero pad past
the capture and the row clamp of ops/sync_torch.py::_aligned_wins.
"""

from __future__ import annotations

import math

import torch

from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
from lte_cell_scanner_tpu_torch.kernels.build import check_launch, launcher
from lte_cell_scanner_tpu_torch.ops.sync_torch import (_aligned_wins, cmul,
                                                       rot_pair)


def fd_demod_plain(cap, idx, foc, bpo, late, wr, wi, cn):
    """Plain PyTorch version of the ``fd_demod`` kernel (same arguments)."""
    g, j, b = _aligned_wins(cap, idx)                  # (N, 128, 2)
    x = cmul(g, rot_pair(bpo[:, None] + foc[:, None] * j))
    y = torch.stack([x[..., 0] @ wr - x[..., 1] @ wi,
                     x[..., 0] @ wi + x[..., 1] @ wr], dim=-1)
    return cmul(y, rot_pair(
        -2.0 * math.pi * (late - b.to(cap.dtype))[:, None] * cn / 128.0))


def fd_demod(cap: torch.Tensor, idx: torch.Tensor, foc: torch.Tensor,
             bpo: torch.Tensor, late: torch.Tensor, wr: torch.Tensor,
             wi: torch.Tensor, cn: torch.Tensor) -> torch.Tensor:
    """Demodulate N symbol windows of a capture.

    cap (n_cap, 2) f32 re/im; idx (N,) i32 window starts; foc, bpo, late
    (N,) f32 (FOC rate per sample, bulk phase, fractional lateness);
    wr, wi (128, 72) f32 DFT matrices; cn (72,) f32 subcarrier indices.
    Returns (N, 72, 2) f32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel.
    """
    if cap.device.type == "cpu":
        return fd_demod_plain(cap, idx, foc, bpo, late, wr, wi, cn)
    n = idx.shape[0]
    want = ((cap, torch.float32, (cap.shape[0], 2)),
            (idx, torch.int32, (n,)), (foc, torch.float32, (n,)),
            (bpo, torch.float32, (n,)), (late, torch.float32, (n,)),
            (wr, torch.float32, (128, 72)), (wi, torch.float32, (128, 72)),
            (cn, torch.float32, (72,)))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != cap.device:
            raise ValueError(f"fd_demod: want a contiguous {dtype} {shape} on "
                             f"{cap.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    out = torch.empty((n, 72, 2), dtype=torch.float32, device=cap.device)
    if n == 0:
        return out
    code = launcher("fd_demod")(
        cap.data_ptr(), cap.shape[0], idx.data_ptr(), foc.data_ptr(),
        bpo.data_ptr(), late.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        cn.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(cap.device).cuda_stream)
    check_launch("fd_demod", code)
    LAUNCHES["fd_demod"] += 1
    return out
