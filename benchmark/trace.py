"""What a traced run records: the benchmark's own host-clock spans around
the calls into each layer, and a torch.profiler trace of the window's
last seconds, reduced to what the per-layer readers need.

Spans are kept in memory: total seconds per name. The profiler
records CPU and CUDA activity; the reduction keeps the device events
(kernels, copies, sets), the union of their intervals (busy time), the
kernel totals by name, and the idle gaps between device activity named by
the innermost host operation that was running at each gap's middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

BREAKDOWN_ENTRIES = 10
NAMED_GAPS = 500         # the longest gaps that are named


class Spans:
    """Host-clock seconds per span name."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.on = True
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block; while a profiler runs (``annotate``), mark it
        in the trace as ``bench.<name>`` instead, so that the idle gaps
        inside it are named after the layer."""
        if self.annotate:
            from torch.autograd.profiler import record_function

            with record_function(f"bench.{name}"):
                yield
            return
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` under ``name`` (an instance
        attribute shadows the method; nothing of the program changes)."""
        inner = getattr(obj, attr)

        def timed(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, timed)


@dataclasses.dataclass
class DeviceTrace:
    """The reduction of one profiled stretch of the window."""

    window_s: float                     # host clock, start to stop
    busy_s: float                       # union of device activity
    n_device_ops: int
    kernels: Dict[str, Tuple[int, float]]   # name -> (count, seconds)
    device_ops: List[List]              # [[name, seconds]], top by time
    idle_gaps: List[List]               # [[host activity, seconds]]


class Profiled:
    """The profiler over part of the window, on a CUDA device. Kineto's
    raw events are read as they are (name, device or host, start, end),
    without the profiler's per-event Python objects, which take minutes
    for a trace of the tracker's many small operations."""

    def __init__(self, device):
        self.device = device
        self.t0 = 0.0

    def start(self) -> None:
        import torch
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        from torch.autograd.profiler import (ProfilerConfig, ProfilerState,
                                             _enable_profiler,
                                             _prepare_profiler)

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        _prepare_profiler(config, activities)
        torch.cuda.synchronize(self.device)
        _enable_profiler(config, activities)
        self.t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        import torch
        from torch.autograd import DeviceType
        from torch.autograd.profiler import _disable_profiler

        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        rows = []
        for e in _disable_profiler().events():
            on_device = e.device_type() == DeviceType.CUDA
            if on_device and e.is_user_annotation():
                continue    # a span's mirror on the device's timeline
            rows.append((e.name(), on_device, e.start_ns() * 1e-3,
                         e.end_ns() * 1e-3))
        return reduce_events(rows, window_s)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge (n, 2) intervals sorted by start into disjoint ones."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def reduce_events(rows, window_s: float) -> DeviceTrace:
    """Reduce profiler rows (name, on the device, start us, end us) to a
    :class:`DeviceTrace`."""
    dev = [(n, s, e) for n, d, s, e in rows if d]
    host = [(n, s, e) for n, d, s, e in rows if not d]
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, s, e in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    busy = np.zeros((0, 2))
    if dev:
        iv = np.array([(s, e) for _, s, e in dev])
        busy = _union(iv[np.argsort(iv[:, 0], kind="stable")])
    return DeviceTrace(
        window_s=window_s,
        busy_s=float(np.sum(busy[:, 1] - busy[:, 0])) * 1e-6,
        n_device_ops=len(dev),
        kernels={k: (int(v[0]), float(v[1])) for k, v in kernels.items()},
        device_ops=[[k, v[1]] for k, v in top[:BREAKDOWN_ENTRIES]],
        idle_gaps=_name_gaps(busy, host))


def _name_gaps(busy: np.ndarray, host) -> List[List]:
    """Seconds of the longest idle gaps between device activity, summed by
    the innermost host operation running at each gap's middle."""
    if len(busy) < 2 or not host:
        return []
    gaps = np.stack([busy[:-1, 1], busy[1:, 0]], axis=1)
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:NAMED_GAPS]]
    names = [h[0] for h in host]
    hs = np.array([h[1] for h in host])
    he = np.array([h[2] for h in host])
    by_name: Dict[str, float] = defaultdict(float)
    for s, e in longest:
        mid = 0.5 * (s + e)
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        name = "(no host operation)"
        if len(inside):
            name = names[inside[np.argmin(he[inside] - hs[inside])]]
        by_name[name] += (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return [[k, v] for k, v in top[:BREAKDOWN_ENTRIES]]


@dataclasses.dataclass
class Window:
    """What a per-layer reader reads: counts of work over the untraced
    part of the window and over the traced part, the spans of the
    untraced part, the device trace, and the shapes of the cell."""

    units: Dict[str, float]          # untraced part: e.g. carriers, signal_s
    traced_units: Dict[str, float]   # traced part
    spans: Dict[str, float]          # untraced part, seconds by name
    trace: Optional[DeviceTrace]
    shapes: Dict[str, int]
