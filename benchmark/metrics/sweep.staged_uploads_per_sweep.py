"""Shard stacks that reached the card through the sweep stack's staging
buffer per sweep (the counter ``sweep.staged_uploads``: complex captures
cast chunk by chunk into a cached pinned buffer while the previous chunk
is copied). On one card 1: one stack a sweep. A program that converts the
stack on the host and copies it from pageable memory reads 0.

The program's tracer, over the traced run's profiled part
(``benchmark/program.py``): one ``sweep`` span a sweep."""

from benchmark.program import count_per


def read(win):
    return count_per(win, "sweep", "sweep.staged_uploads", "sweeps")
