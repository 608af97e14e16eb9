"""Host waits on the card the engine made per block of input (the counter
``engine.waits``).

The program's tracer, over the traced run's profiled part
(``benchmark/program.py``): one ``tracker.step`` span a block."""

from benchmark.program import count_per


def read(win):
    return count_per(win, "tracker.step", "engine.waits", "blocks")
