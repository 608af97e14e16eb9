"""The benchmark of the PyTorch and CUDA port (``lte_cell_scanner_tpu_torch``).

Run a cell of ``BENCHMARK.json`` from the root of a checkout::

    python3 -m benchmark.run --workload band17.sweep --seed 7 \\
        --seconds 20 --trace 0

The harness is driven by data: a cell names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``),
which names the entry that drives the program (``entries/<entry>.py``)
and the generator of its signal (``sim/<generator>.py``); a per-layer
metric is a reader in ``metrics/<metric>.py`` (or one shared by its
suffix, ``metrics/device_idle.py``); a kernel's operation and byte count
sit in ``rooflines/<kernel>.py``. The plain reference that decides
``correct`` is ``reference/``, its control ``control.py``, and the signal
generator ``sim/``: frozen copies that import nothing of the port, and
neither ``jax`` nor the JAX package.
"""
