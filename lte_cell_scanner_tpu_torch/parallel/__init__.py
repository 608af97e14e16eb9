from lte_cell_scanner_tpu_torch.parallel.sharded_search import (  # noqa: F401
    sharded_xcorr_pss,
    make_search_mesh,
)
from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (  # noqa: F401
    make_cap_mesh,
    sharded_fc_sweep,
)
from lte_cell_scanner_tpu_torch.parallel.multihost import (  # noqa: F401
    dryrun_multihost,
    init_multihost,
)
