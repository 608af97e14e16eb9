"""The capture front end: .it files, raw rtl_sdr bytes, recordings, the
simulator and the wideband channelizer."""

from lte_cell_scanner_tpu_torch.io.itfile import (  # noqa: F401
    load_it,
    save_it,
)
from lte_cell_scanner_tpu_torch.io.raw import load_rtl_sdr  # noqa: F401
