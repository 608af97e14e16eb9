"""MIBs the engine decoded per block of input (the counter
``engine.mib_decodes``). Four cells that each decode in every 40 ms PBCH
period read 4 x 10,000 / 76,800 = 0.52.

The program's tracer, over the traced run's profiled part
(``benchmark/program.py``): one ``tracker.step`` span a block. Nothing
for a program without the counter (it comes with ``engine.cell_cycles``,
which every cycle counts), or where the tracer recorded nothing (the
CPU)."""

from benchmark.program import count_per, snapshot


def read(win):
    snap = snapshot()
    if snap is None or "engine.cell_cycles" not in snap["counts"]:
        return None
    return count_per(win, "tracker.step", "engine.mib_decodes", "blocks")
