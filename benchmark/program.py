"""What the program's own tracer counted, for the per-layer readers of its
counters (``lte_cell_scanner_tpu_torch/utils/profiling.py``).

The tracer records while the autograd profiler records, and nothing in a
benchmark run enables it otherwise: so in a traced run it holds the
window's profiled last seconds and nothing else, one cell a process, and
a reader divides what it counted by the work of that part
(``win.traced_units``). :func:`count_per` checks that: the layer's top
span must have been opened once for each unit of that part, else the
tracer recorded work outside it, and the reader raises. Counters only;
the tracer's host times carry the profiler's cost there, and are not
read. A program without the tracer, or a run in which it recorded
nothing of the layer (no profiler: the CPU), gives None.
"""

from __future__ import annotations

from typing import Optional


def snapshot() -> Optional[dict]:
    """The tracer's aggregates, or None for a program without it."""
    try:
        from lte_cell_scanner_tpu_torch.utils.profiling import TRACER
    except ImportError:
        return None
    return TRACER.snapshot()


def count_per(win, top: str, counter: str, unit: str) -> Optional[float]:
    """The counter ``counter`` per ``unit`` of the profiled part, whose
    every unit opened the span ``top`` once; a counter missing beside
    ``top`` reads 0."""
    snap = snapshot()
    n = win.traced_units.get(unit, 0.0)
    if snap is None or not n or top not in snap["spans"]:
        return None
    calls = snap["spans"][top]["calls"]
    if calls != n:
        raise RuntimeError(
            f"the tracer opened {calls} spans {top!r} for {n:g} {unit} of "
            f"the profiled part: it recorded outside that part")
    return snap["counts"].get(counter, 0) / n
