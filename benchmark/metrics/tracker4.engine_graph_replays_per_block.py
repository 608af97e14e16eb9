"""``tracker.engine_graph_replays_per_block``'s reading in the four-cell
cell: CUDA graph replays of the engine's demod and stats programs per
block of input (the counter ``engine.graph_replays``), over the traced
run's profiled part. Nothing where the engine ran no program on a card."""

from pathlib import Path

from benchmark.manifest import load_module

read = load_module(
    Path(__file__).with_name("tracker.engine_graph_replays_per_block.py")
).read
