"""The cell search: ``cell_search`` (one capture), the batched sweeps
(pipeline.py, wideband.py) and the CLI."""

from lte_cell_scanner_tpu_torch.search.cell_search import (  # noqa: F401
    cell_search,
    detection_threshold,
    dedup,
    generate_search_sets,
)
