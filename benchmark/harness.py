"""One run of one cell: set up, warm up, measure for ``seconds``, judge.

:func:`run_cell` does the work on any torch device and returns a
:class:`Run`; :func:`result_line` turns a run on the card into the result
object, and refuses a run on another device, so that no number from the
CPU is ever written under a device metric's name.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from benchmark import check
from benchmark.entries import make_entry
from benchmark.manifest import ROOT, load_cell, metric_readers
from benchmark.trace import Profiled, Spans, Window

BANNED = ("jax", "jaxlib", "flax", "lte_cell_scanner_tpu")
# A traced run profiles the window's last TRACE_S seconds (at most half
# of the window, and at least one unit of work); its spans cover the
# part before.
TRACE_S = 3.0


@dataclasses.dataclass
class Run:
    cell: str
    device: object
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Dict]
    checks: Dict[str, Dict]
    setup_parts: Dict[str, float]
    memory_peak_bytes: int = 0
    trace: Optional[object] = None
    check_s: float = 0.0
    answers: Optional[dict] = None      # the tracker's, for the log


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`BANNED`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in BANNED})


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             root: Path = ROOT, overrides: Optional[dict] = None,
             parts: Optional[Dict[str, float]] = None) -> Run:
    """Run the cell ``name`` once. ``overrides`` ({"config": {...},
    "traffic": {...}}) replace entries of the cell's files (tests run a
    tiny cell on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    parts = {} if parts is None else parts
    cell = load_cell(name, root)
    for key, new in (overrides or {}).items():
        getattr(cell, key).update(new)
    readers = metric_readers(cell, root) if trace else {}

    t = time.perf_counter()
    import torch

    import lte_cell_scanner_tpu_torch  # noqa: F401  the program
    parts["import"] = parts.get("import", 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    parts["cuda_init"] = time.perf_counter() - t
    if dev.type == "cuda":
        from lte_cell_scanner_tpu_torch.kernels.build import build

        t = time.perf_counter()
        build()
        parts["build"] = time.perf_counter() - t

    spans = Spans()
    entry = make_entry(cell.config, cell.traffic, seed, dev, spans, root)
    entry.setup(parts)
    if trace and hasattr(entry, "instrument"):
        entry.instrument()
    spans.seconds.clear()

    # ---- the window.
    trace_s = min(TRACE_S, seconds / 2) if trace else 0.0
    units: Dict[str, float] = {}
    traced_units: Dict[str, float] = {}
    dtrace = None

    def add(bucket, done):
        for k, v in done.items():
            bucket[k] = bucket.get(k, 0.0) + v

    t0 = time.perf_counter()
    parts_total = t0 - t_start
    while time.perf_counter() - t0 < seconds - trace_s:
        add(units, entry.step())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    untraced_spans = dict(spans.seconds)
    if trace:
        spans.on = False
        spans.annotate = dev.type == "cuda"
        prof = Profiled(dev) if dev.type == "cuda" else None
        if prof is not None:
            prof.start()
        t1 = time.perf_counter()
        while not traced_units or time.perf_counter() - t1 < trace_s:
            add(traced_units, entry.step())
        if prof is not None:
            dtrace = prof.stop()

    # ---- after the window: memory, answers, then the reference.
    attempted = int(units.get(entry.unit, 0) + traced_units.get(entry.unit,
                                                                0))
    memory = (int(torch.cuda.max_memory_allocated(dev))
              if dev.type == "cuda" else 0)
    if hasattr(entry, "finish"):
        all_units = dict(units)
        add(all_units, traced_units)
        entry.finish(all_units)
    entry.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ok, checks = check.judge(entry.numbers(), cell.config["check"])
    check_s = time.perf_counter() - t

    metrics: Dict[str, Dict] = {}
    if trace:
        win = Window(units=units, traced_units=traced_units,
                     spans=untraced_spans, trace=dtrace, shapes=entry.shapes)
        for m in cell.per_layer:
            value = readers[m["name"]](win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = entry.end_to_end(units, elapsed)
        e2e["setup_s"] = parts_total
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    parts["total"] = parts_total
    return Run(cell=name, device=dev, correct=ok, attempted=attempted,
               failed=0, metrics=metrics, checks=checks, setup_parts=parts,
               memory_peak_bytes=memory, trace=dtrace, check_s=check_s,
               answers=getattr(entry, "answers", None))


def result_line(run: Run) -> dict:
    """The result object of a run on the card."""
    import torch

    if run.device.type != "cuda":
        raise RuntimeError("a run on the CPU reports no device metric")
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(run.device),
              "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": run.metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = run.checks
    return out
