"""Channelizer tables built per wideband sweep (the counter
``wideband.table_builds``: misses of the channelizer's table cache). In a
steady state 0: a sweep that builds its 2 B x 2 x L kernel and rotation
tables anew each time shows here.

The program's tracer, over the traced run's profiled part
(``benchmark/program.py``): one ``wideband`` span a sweep."""

from benchmark.program import count_per


def read(win):
    return count_per(win, "wideband", "wideband.table_builds", "sweeps")
