"""``tracker.engine_waits_per_block``'s reading in the four-cell cell:
host waits on the card the engine made per block of input (the counter
``engine.waits``), over the traced run's profiled part."""

from pathlib import Path

from benchmark.manifest import load_module

read = load_module(
    Path(__file__).with_name("tracker.engine_waits_per_block.py")).read
