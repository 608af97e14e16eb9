"""``tracker.feeder_ms_per_s``'s reading in the four-cell cell: the
benchmark's span ``feeder`` over the untraced part of the window, host
ms per second of signal."""

from pathlib import Path

from benchmark.manifest import load_module

read = load_module(Path(__file__).with_name("tracker.feeder_ms_per_s.py")).read
