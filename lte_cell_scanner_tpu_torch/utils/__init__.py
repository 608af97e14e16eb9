"""DSP primitives (dsp), device selection and profiling helpers."""

from lte_cell_scanner_tpu_torch.utils import dsp  # noqa: F401
