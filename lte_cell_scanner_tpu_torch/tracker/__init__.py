"""The tracker (LTE-Tracker): LTETracker and its shared state.

``LTETracker`` is imported on first access: ops/fd_demod.py imports
tracker/batch_frontend.py, which the tracker's runtime imports back.
"""

from lte_cell_scanner_tpu_torch.tracker.state import (  # noqa: F401
    GlobalState,
    TrackedCell,
)


def __getattr__(name):
    if name == "LTETracker":
        from lte_cell_scanner_tpu_torch.tracker.runtime import LTETracker

        return LTETracker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
