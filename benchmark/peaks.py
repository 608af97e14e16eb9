"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores, FMA = 2
PEAK_TF32_FLOPS = 495e12    # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12    # bf16 on the tensor cores
PEAK_BYTES = 3.35e12        # HBM3 bytes per second


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the operations
    over their peak and the bytes over the memory's."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
