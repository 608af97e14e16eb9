"""Scan tables with planted features for the greedy peak search's tests:
tests/test_torch_peak.py holds the plain version to the JAX package's
loop on them, tests/test_torch_peak_card.py the ``peak_greedy`` kernel to
the plain version on the card. numpy only.

Each case is one capture's (packed (7, 9600), single (3, 9600, N_F))
float32 tables over a background below the detection threshold
(r_norm * sp with R_NORM, ARM):

- ``ties``: equal peaks on several rows and lags (the argmax's first flat
  index decides), values exactly at and just under pp * DB8 beside a
  peak on another row, peaks at cyclic distance 274 and 275 across the
  9600-lag wrap, and ties in the refinement windows;
- ``nan_row``: one pow row all NaN (the first trip fails: no peak);
- ``nan_refine``: the ties case with a NaN in a refinement window (the
  refined lag goes to it) and a NaN sp where no peak stands;
- ``dense``: 34 peaks a row, 275 lags apart, 102 in all (a first pass of
  64 fills; PEAK_BOUND = 102 trips find every one);
- ``noise``: the background alone.
"""

import numpy as np

N_LAGS = 9600
N_F = 5
ARM = 2
N_COMB = 15
R_NORM = 0.02381296538785027         # r_th1_normalized(N_COMB, ARM)
DB8 = 10.0 ** (-8.0 / 10.0)
KINDS = ("ties", "nan_row", "nan_refine", "dense", "noise")


def _background(rng):
    packed = np.zeros((7, N_LAGS), np.float32)
    packed[0:3] = rng.uniform(0.0, 0.01, (3, N_LAGS))
    packed[3:6] = rng.integers(0, N_F, (3, N_LAGS))
    packed[6] = 2.0          # threshold r_norm * 2 ~ 0.048 over the noise
    single = rng.uniform(0.0, 1.0, (3, N_LAGS, N_F)).astype(np.float32)
    return packed, single


def _refine_tie(packed, single, row, lag, value=2.0):
    """single[row, lag + 1 and lag - 2, foi] equal (mod 9600): the first
    (-2) wins."""
    foi = int(packed[3 + row, lag])
    for d in (-2, 1):
        single[row, (lag + d) % N_LAGS, foi] = value


def capture(kind: str, rng):
    packed, single = _background(rng)
    if kind == "noise":
        return packed, single
    if kind == "nan_row":
        packed[1] = np.nan
        return packed, single
    if kind == "dense":
        packed[0:3] = 0.0
        packed[6] = 1e-6
        for r in range(3):
            lags = r * 91 + 275 * np.arange(34)
            packed[r, lags] = rng.uniform(1.0, 1.5, 34)
        return packed, single
    pow_ = packed[0:3]
    for row, lag in ((2, 100), (0, 5000), (1, 7000), (0, 9590), (2, 7000),
                     (1, 9599)):
        pow_[row, lag] = 1.0
        _refine_tie(packed, single, row, lag)
    t8 = np.float32(1.0) * np.float32(DB8)
    pow_[1, 5000 + 10] = t8                    # stays (not below)
    pow_[2, 5000 - 10] = np.nextafter(t8, np.float32(0.0))  # cleared
    pow_[0, (9590 + 274) % N_LAGS] = 0.5       # same row, 274 away: cleared
    pow_[0, (9590 + 275) % N_LAGS] = 0.5       # 275 away: a later peak
    pow_[1, 3000] = 0.5                        # two equal lesser peaks
    pow_[2, 3000] = 0.5
    if kind == "nan_refine":
        foi = int(packed[3 + 0, 5000])
        single[0, 5000 - 1, foi] = np.nan
        packed[6, 1234] = np.nan
    return packed, single


def stack(kinds, seed: int):
    """(B, 7, 9600) and (B, 3, 9600, N_F) float32 of the cases ``kinds``,
    each drawn from its own generator of ``seed``."""
    cases = [capture(k, np.random.default_rng([seed, i]))
             for i, k in enumerate(kinds)]
    return (np.stack([c[0] for c in cases]),
            np.stack([c[1] for c in cases]))
