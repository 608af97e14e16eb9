"""LTE PHY tables and codecs, and the Viterbi decoder's kernel wrapper."""

from lte_cell_scanner_tpu_torch.models.cell import Cell  # noqa: F401
from lte_cell_scanner_tpu_torch.models.pn import lte_pn  # noqa: F401
from lte_cell_scanner_tpu_torch.models.pss import (  # noqa: F401
    pss_fd,
    pss_td,
)
from lte_cell_scanner_tpu_torch.models.sss import sss_fd  # noqa: F401
from lte_cell_scanner_tpu_torch.models.rs import RSDL  # noqa: F401
from lte_cell_scanner_tpu_torch.models.crc import lte_calc_crc  # noqa: F401
from lte_cell_scanner_tpu_torch.models.convcode import (  # noqa: F401
    lte_conv_encode,
    lte_conv_decode,
)
from lte_cell_scanner_tpu_torch.models.ratematch import (  # noqa: F401
    lte_conv_ratematch,
    lte_conv_deratematch,
)
from lte_cell_scanner_tpu_torch.models.modulation import (  # noqa: F401
    lte_modulate,
    lte_demodulate,
)
