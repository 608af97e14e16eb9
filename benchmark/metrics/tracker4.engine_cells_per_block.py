"""Cells the engine's cycles carried per block of input (the counter
``engine.cell_cycles``: the cells that had symbols in a ``process_all``
cycle). With the engine every block it reads the number of cells
tracked, 4.0 when every cell of a four-cell site is served every cycle.

The program's tracer, over the traced run's profiled part
(``benchmark/program.py``): one ``tracker.step`` span a block. Nothing
for a program without the counter, or where the tracer recorded nothing
(the CPU)."""

from benchmark.program import count_per, snapshot


def read(win):
    snap = snapshot()
    if snap is None or "engine.cell_cycles" not in snap["counts"]:
        return None
    return count_per(win, "tracker.step", "engine.cell_cycles", "blocks")
