"""Operations and bytes of the wideband channelizer's convolution
(``search/wideband.py::Channelizer``: one strided ``F.conv1d`` of the
recording's two float32 planes with the modulated kernel of every
carrier, TF32 off).

Operations: n_out outputs x 2 L taps (the re and im planes) x 2 B output
rows (re and im of B carriers) multiply-adds of 2 flops each, against
float32 outside the tensor cores (TF32 is off). Bytes: the planes read
once (2 x n_wide float32), the kernel read once (2 B x 2 x L float32) and
the channels written once (2 B x n_out float32). The post-rotation (two
broadcast complex products) is not counted, nor timed: ``KERNELS`` names
the kernels the convolution launches on an H100, cuDNN's choice for the
call, found by profiling ``Channelizer.__call__`` alone at B = 271 (torch
2.11, CUDA 12.8): an implicit-GEMM convolution and its index table.
"""

from benchmark.peaks import PEAK_F32_FLOPS, bound_s

KERNELS = ("precomputed_convolve_sgemm", "kern_precompute_indices")


def flops(n_out: int, taps: int, b: int) -> float:
    return 2.0 * n_out * 2 * taps * 2 * b


def nbytes(n_wide: int, n_out: int, taps: int, b: int) -> float:
    return 4.0 * (2 * n_wide + 2 * b * 2 * taps + 2 * b * n_out)


def bound(n_wide: int, n_out: int, taps: int, b: int) -> float:
    """Seconds one call over ``b`` carriers needs at the least."""
    return bound_s(flops(n_out, taps, b), nbytes(n_wide, n_out, taps, b),
                   PEAK_F32_FLOPS)
