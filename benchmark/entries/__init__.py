"""The program's entry points as the benchmark drives them, found by name.

A traffic mix names its ``entry`` and its ``generator``: the entry is the
class ``Entry`` of ``entries/<entry>.py``, the generator the module
``sim/<generator>.py``. A new kind of entry or of traffic is a new file
here or there, and no file of the benchmark changes.

Each entry takes the cell's configuration and mix, makes its inputs from
the seed with its generator, warms up every shape it will use
(``setup``), runs one unit of work per ``step``, and after the window
hands its answers to the reference (``numbers``). The program is
imported inside the entries, so that its import counts as set-up and a
directory without it fails at once.
"""

from __future__ import annotations

from pathlib import Path

from benchmark.manifest import ROOT, load_module


def make_entry(config: dict, traffic: dict, seed: int, device, spans,
               root: Path = ROOT):
    """The entry of a cell, with its generator."""
    here = root / "benchmark"
    cls = load_module(here / "entries" / f"{traffic['entry']}.py").Entry
    gen = load_module(here / "sim" / f"{traffic['generator']}.py")
    return cls(config, traffic, seed, device, spans, gen)
