"""Host waits on the card a capture's ``cell_search`` made (the counter
``search.waits``).

The program's tracer, over the traced run's profiled part
(``benchmark/program.py``)."""

from benchmark.program import count_per


def read(win):
    return count_per(win, "search", "search.waits", "carriers")
