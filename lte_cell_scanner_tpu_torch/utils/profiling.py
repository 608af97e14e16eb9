"""Profiling: per-stage wall-clock + throughput counters and device traces.

reference: the reference's only instrumentation is a Real_Timer around the
searcher cycle (src/searcher_thread.cpp:82-85) plus commented-out timing
hooks (src/searcher.cpp:143,173). Here timing is a first-class utility:

- ``StageTimer`` accumulates wall-clock and item counts per named stage
  (use as a context manager); ``report()`` prints ms/call and items/s.
  Give it ``sync=torch.cuda.synchronize``-like callables to end a stage
  only when its device work is done.
- ``device_trace`` records the enclosed region with ``torch.profiler``
  (host and CUDA activity) and writes a Chrome trace.

Example:
    timer = StageTimer()
    with timer("scan", items=len(capbuf)):
        r = xcorr_core(cap2, plan, 2)
    print(timer.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class _Stage:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0


@dataclass
class StageTimer:
    stages: Dict[str, _Stage] = field(default_factory=dict)
    sync: Optional[object] = None   # called with ``result`` at stage end

    @contextlib.contextmanager
    def __call__(self, name: str, items: float = 0.0, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None and result is not None:
                self.sync(result)
            st = self.stages.setdefault(name, _Stage())
            st.calls += 1
            st.seconds += time.perf_counter() - t0
            st.items += items

    def report(self, unit: str = "items") -> str:
        rows = [f"{'stage':<24} {'calls':>6} {'total s':>9} "
                f"{'ms/call':>9} {unit + '/s':>14}"]
        for name, st in sorted(self.stages.items(),
                               key=lambda kv: -kv[1].seconds):
            rate = st.items / st.seconds if st.seconds and st.items else 0
            rows.append(f"{name:<24} {st.calls:>6} {st.seconds:>9.3f} "
                        f"{1e3 * st.seconds / max(st.calls, 1):>9.2f} "
                        f"{rate:>14,.0f}")
        return "\n".join(rows)

    def reset(self) -> None:
        self.stages.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record the enclosed region with torch.profiler (CPU and, where the
    card is there, CUDA activity) into ``log_dir/trace.json``, a Chrome
    trace; yields the profiler so a caller can read ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
