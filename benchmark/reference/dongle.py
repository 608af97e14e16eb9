"""A looping recording as a dongle whose one crystal is off by delta
samples it, evaluated from the definition in float64: the plain reference
of the benchmark's dongle generator (``benchmark/sim/dongle.py``).

Kept in two equal copies, ``benchmark/reference/dongle.py`` (the
benchmark's reference) and ``tests/plain_dongle.py`` (the test suite's);
it imports neither JAX nor anything of the program. Plain numpy, float64
and complex128, O(n * n') operations: for short signals only.

1. The recording x of n samples is one period of its trigonometric
   series: x(t) = (1/n) sum_k X[k] exp(2j pi k t / n), X its DFT computed
   here as a sum, k over -n/2 .. n/2 with the Nyquist bin of an even n
   split in halves between -n/2 and +n/2.
2. The dongle's clock at fs (1 + delta), delta = m / n, takes n' = n + m
   samples over the loop, at t_j = j n / n' samples of x.
3. Its LO at fc (1 + delta) puts the carrier at -delta fc: sample j is
   rotated by exp(-2j pi delta fc (j n / n') / fs).
"""

from __future__ import annotations

import numpy as np


def dongle_samples(x: np.ndarray, slip: int, fc: float, fs: float,
                   j: np.ndarray) -> np.ndarray:
    """Samples ``j`` (any integers; j = n' is the loop's next start) of
    ``x`` as the dongle of ``slip`` samples a loop records them."""
    x = np.asarray(x, dtype=np.complex128)
    n = len(x)
    n_new = n + slip
    ell = np.arange(n)
    ks = np.arange(-(n // 2), n // 2 + 1)      # n + 1 terms for an even n
    weights = np.ones(len(ks))
    if n % 2 == 0:
        weights[0] = weights[-1] = 0.5
    coef = np.array([np.sum(x * np.exp(-2j * np.pi * k * ell / n))
                     for k in ks]) * weights
    t = np.asarray(j, dtype=np.float64) * n / n_new
    series = np.array([np.sum(coef * np.exp(2j * np.pi * ks * tj / n))
                       for tj in t]) / n
    delta = slip / n
    return series * np.exp(-2j * np.pi * delta * fc * t / fs)
