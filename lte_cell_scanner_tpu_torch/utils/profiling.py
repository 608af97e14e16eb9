"""The program's tracer: named spans with calls and seconds, and counters.

reference: the reference's only instrumentation is a Real_Timer around the
searcher cycle (src/searcher_thread.cpp:82-85) plus commented-out timing
hooks (src/searcher.cpp:143,173).

:data:`TRACER`, one :class:`StageTimer` per process, is what the search,
the sweeps and the tracker open their spans on. Names are
``layer.stage`` (``search.scan``, ``engine.demod``); ``wait()`` is a span
around a host wait on the card, named after the innermost open span's
layer (``engine.demod`` -> ``engine.wait``), which also counts
``<layer>.waits``.

- **Off** (the default), ``span`` and ``wait`` return one shared object
  whose enter and exit do nothing: no clock read, no allocation, no
  profiler range.
- **On**, after :meth:`StageTimer.enable` or while the autograd profiler
  records, each span reads ``time.perf_counter()`` at enter and exit and
  adds its duration to its name's ``calls`` and ``seconds`` and to its
  parent's child seconds: ``self_s`` is seconds minus child seconds. No
  per-span record is kept. While the profiler records, a span is also a
  ``record_function("lte.<name>")`` range on the profiler's own clock, so
  that a trace names the device's idle gaps after the program's stages;
  the profiler's nested ranges are then the span log. So the off path
  is a flag test and one query of the profiler's state, and a process
  that profiles gathers aggregates until :meth:`StageTimer.reset`: the
  benchmark's readers (``benchmark/program.py``) read a traced run's
  profiled part that way, and check that nothing else was recorded.
- ``count`` always counts. ``wait`` counts ``<layer>.waits`` only while
  the tracer is on: the layer is the open span's, and spans are kept
  only then.

Example:
    TRACER.enable()
    TRACER.reset()
    cell_search(capbuf, fc)
    TRACER.snapshot()["spans"]["search.scan"]   # {calls, seconds, self_s}
"""

from __future__ import annotations

from functools import wraps
from time import perf_counter
from typing import Dict, List

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function


class _Stage:
    __slots__ = ("calls", "seconds", "child")

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self.child = 0.0


class _NoSpan:
    """The span of a tracer that is off: enter and exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "t0", "range")

    def __init__(self, tracer: "StageTimer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.tracer._stack.append(self.name)
        self.range = None
        if _profiler_enabled():
            self.range = record_function("lte." + self.name)
            self.range.__enter__()
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        tracer = self.tracer
        stack = tracer._stack
        stack.pop()
        st = tracer._stage(self.name)
        st.calls += 1
        st.seconds += dt
        if stack:
            tracer._stage(stack[-1]).child += dt
        return False


class StageTimer:
    """Spans and counters of one process (:data:`TRACER`); see the module
    docstring. One thread opens spans at a time."""

    stages: Dict[str, _Stage]

    def __init__(self):
        self.on = False
        self.stages = {}
        self.counts: Dict[str, int] = {}
        self._stack: List[str] = []

    def _stage(self, name: str) -> _Stage:
        st = self.stages.get(name)
        if st is None:
            st = self.stages[name] = _Stage()
        return st

    def span(self, name: str):
        """A context that times its block under ``name`` while the tracer
        is on (enabled, or the autograd profiler recording)."""
        if self.on or _profiler_enabled():
            return _Span(self, name)
        return _NO_SPAN

    def traced(self, name: str):
        """A decorator: the function's calls are spans ``name``."""
        def wrap(fn):
            @wraps(fn)
            def run(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)
            return run
        return wrap

    def wait(self):
        """A span around a host wait on the card: ``<layer>.wait``, the
        layer being the first part of the innermost open span's name
        (``wait`` outside any span); counts ``<layer>.waits`` while the
        tracer is on."""
        if not (self.on or _profiler_enabled()):
            return _NO_SPAN
        layer = self._stack[-1].split(".", 1)[0] if self._stack else ""
        prefix = layer + "." if layer else ""
        self.count(prefix + "waits")
        return _Span(self, prefix + "wait")

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        """Clear the span aggregates and the counters."""
        self.stages.clear()
        self.counts.clear()

    def snapshot(self) -> dict:
        """``{"spans": {name: {calls, seconds, self_s}}, "counts": {name:
        n}}`` since the last reset."""
        return {"spans": {name: {"calls": st.calls, "seconds": st.seconds,
                                 "self_s": st.seconds - st.child}
                          for name, st in self.stages.items() if st.calls},
                "counts": dict(self.counts)}


TRACER = StageTimer()
