"""PyTorch/CUDA port of lte_cell_scanner_tpu for NVIDIA Hopper cards:
LTE cell search and tracking from 1.92 Msps IQ captures, with the device
path's kernels hand-written in CUDA (csrc/) and a float64 host path
(``backend="numpy"``) beside it."""

from lte_cell_scanner_tpu_torch.constants import (  # noqa: F401
    CAPLENGTH, FS_LTE)
from lte_cell_scanner_tpu_torch.models.cell import Cell  # noqa: F401
