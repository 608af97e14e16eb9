"""The plain reference of the benchmark: a frozen float64 NumPy copy of the
port's host search chain (PSS scan, greedy peaks, SSS detection, fine FOE,
time/frequency grid, channel estimate, blind MIB decode).

It imports nothing of the port and neither ``jax`` nor the JAX package, so
that a change to the program cannot move the yardstick. Each module keeps
the docstring and the source citations of the file it was copied from;
:mod:`benchmark.reference.search` is the entry.
"""
