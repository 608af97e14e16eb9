"""The search's operations: the float64 host chain (xcorr, peak, sync,
tfg, chanest, pbch) and the device programs and kernel wrappers
(``*_torch.py``, fd_demod.py)."""

from lte_cell_scanner_tpu_torch.ops.xcorr import (  # noqa: F401
    XcorrResult,
    xcorr_pss,
)
from lte_cell_scanner_tpu_torch.ops.peak import peak_search  # noqa: F401
from lte_cell_scanner_tpu_torch.ops.sync import (  # noqa: F401
    pss_sss_foe,
    sss_detect,
)
from lte_cell_scanner_tpu_torch.ops.tfg import extract_tfg, tfoec  # noqa: F401
from lte_cell_scanner_tpu_torch.ops.chanest import chan_est  # noqa: F401
from lte_cell_scanner_tpu_torch.ops.pbch import (  # noqa: F401
    decode_mib,
    pbch_extract,
)
