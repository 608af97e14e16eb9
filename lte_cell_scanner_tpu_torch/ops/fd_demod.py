"""Fused OFDM symbol demodulation (one CUDA kernel body, csrc/fd_demod.cu,
in two modes) and the plain PyTorch version of each mode.

Counterpart of lte_cell_scanner_tpu/ops/fd_demod_pallas.py:

- ``fd_demod``: the MIB mode (f32 samples, ``pre_bpo=True``, the DFT
  :data:`MIB_DFT`), on the search path;
- ``fd_demod_stream``: the tracker (stream) mode (the raw u8 I/Q stream,
  ``pre_bpo=False``, the DFT :data:`TRACKER_DFT`), on the tracker
  engine's path.

The DFT is named, not given as a matrix: a
:class:`~lte_cell_scanner_tpu_torch.tracker.batch_frontend.SubcarrierDFT`
(bins, cyclic shift). The plain versions multiply by its (128, 72)
matrices; the kernel runs a 128-point FFT, selects the bins and applies
the shift as a per-bin factor.

In MIB mode, for the window at sample ``idx``, with a = idx // 128 and
b = idx % 128:

  g[c]   = row a at lanes c >= b, row a+1 below    (cyclic blend)
  j[c]   = c - b + 128*(c < b)                     (true sample index)
  x      = g * exp(i*(bpo + foc*j))                (FOC + bulk phase)
  y      = x @ W(dft)                              (128 -> 72 bins)
  out    = y * exp(-i*2*pi*(late - b)*cn/128)      (timing ramp)

with cn the signed subcarrier index of each bin. The stream mode converts
the samples (v - 127)/128, rotates by foc*j only and applies the bulk
phase after the DFT with the ramp:
out = y * exp(i*(bpo - (2*pi/128)*(late - b)*cn)).

The kernel gathers the two 128-aligned rows itself, with the zero pad past
the samples (u8 127 in stream mode) and the row clamp of
ops/sync_torch.py::_aligned_wins.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
from lte_cell_scanner_tpu_torch.kernels.build import check_launch, launcher
from lte_cell_scanner_tpu_torch.ops.sync_torch import (_aligned_wins, cmul,
                                                       rot_pair)
from lte_cell_scanner_tpu_torch.tracker.batch_frontend import (
    MIB_DFT, TRACKER_DFT, SubcarrierDFT, dft_cn, dft_mats, get_fd_batch,
    on_device)
from lte_cell_scanner_tpu_torch.utils.device import launch_device


def _bins_i32(dft: SubcarrierDFT) -> np.ndarray:
    return np.asarray(dft.bins, dtype=np.int32)


def fd_demod_plain(cap, idx, foc, bpo, late, dft: SubcarrierDFT):
    """Plain PyTorch version of the ``fd_demod`` kernel (same arguments)."""
    wr, wi = on_device(dft_mats, cap.device, dft)
    cn = on_device(dft_cn, cap.device, dft)
    g, j, b = _aligned_wins(cap, idx)                  # (N, 128, 2)
    x = cmul(g, rot_pair(bpo[:, None] + foc[:, None] * j))
    y = torch.stack([x[..., 0] @ wr - x[..., 1] @ wi,
                     x[..., 0] @ wi + x[..., 1] @ wr], dim=-1)
    return cmul(y, rot_pair(
        -2.0 * math.pi * (late - b.to(cap.dtype))[:, None] * cn / 128.0))


def fd_demod(cap: torch.Tensor, idx: torch.Tensor, foc: torch.Tensor,
             bpo: torch.Tensor, late: torch.Tensor,
             dft: SubcarrierDFT) -> torch.Tensor:
    """Demodulate N symbol windows of a capture.

    cap (n_cap, 2) f32 re/im; idx (N,) i32 window starts; foc, bpo, late
    (N,) f32 (FOC rate per sample, bulk phase, fractional lateness); dft
    the named 128 -> 72 DFT. Returns (N, 72, 2) f32. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel.
    """
    if cap.device.type == "cpu":
        return fd_demod_plain(cap, idx, foc, bpo, late, dft)
    return _launch("fd_demod", cap, torch.float32, idx, foc, bpo, late, dft)


def fd_demod_stream_plain(seg_u8, starts, foc, bpo, late):
    """Plain PyTorch version of the ``fd_demod_stream`` kernel (same
    arguments): (seg - 127)/128 -> aligned-blend windows -> get_fd_batch
    (the matrices of :data:`TRACKER_DFT`), the XLA program of the JAX
    engine's _demod_stream_jit."""
    x = (seg_u8.to(torch.float32) - 127.0) * (1.0 / 128.0)
    g, j, b = _aligned_wins(x, starts)
    return get_fd_batch(g, foc, bpo, late - b.to(torch.float32), j=j)


def fd_demod_stream(seg_u8: torch.Tensor, starts: torch.Tensor,
                    foc: torch.Tensor, bpo: torch.Tensor,
                    late: torch.Tensor) -> torch.Tensor:
    """Demodulate N symbol windows of the tracker's raw sample stream.

    seg_u8 (L, 2) u8 raw I/Q; starts (N,) i32 window starts in seg; foc,
    bpo, late (N,) f32 (FOC rate per sample, bulk phase, fractional
    lateness). The DFT is :data:`TRACKER_DFT`. Returns (N, 72, 2) f32. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if seg_u8.device.type == "cpu":
        return fd_demod_stream_plain(seg_u8, starts, foc, bpo, late)
    return _launch("fd_demod_stream", seg_u8, torch.uint8, starts, foc, bpo,
                   late, TRACKER_DFT)


def _launch(name, samples, dtype, idx, foc, bpo, late, dft):
    """Check the arguments of either mode and launch its kernel."""
    n = idx.shape[0]
    want = ((samples, dtype, (samples.shape[0], 2)),
            (idx, torch.int32, (n,)), (foc, torch.float32, (n,)),
            (bpo, torch.float32, (n,)), (late, torch.float32, (n,)))
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != samples.device:
            raise ValueError(f"{name}: want a contiguous {dt} {shape} on "
                             f"{samples.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not isinstance(dft, SubcarrierDFT) or len(dft.bins) != 72 \
            or not all(0 <= b < 128 for b in dft.bins):
        raise ValueError(f"{name}: want a SubcarrierDFT of 72 bins in "
                         f"[0, 128), got {dft!r}")
    bins = on_device(_bins_i32, samples.device, dft)
    if samples.shape[0] == 0:
        raise ValueError(f"{name}: no samples")
    out = torch.empty((n, 72, 2), dtype=torch.float32, device=samples.device)
    if n == 0:
        return out
    with launch_device(samples.device):
        code = launcher(name)(
            samples.data_ptr(), samples.shape[0], idx.data_ptr(),
            foc.data_ptr(), bpo.data_ptr(), late.data_ptr(), bins.data_ptr(),
            int(dft.shift), n, out.data_ptr(),
            torch.cuda.current_stream(samples.device).cuda_stream)
    check_launch(name, code)
    LAUNCHES[name] += 1
    return out
