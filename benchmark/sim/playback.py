"""File playback of a recording as the dongle's uint8 blocks.

A frozen copy of the port's ``tracker/runtime.py::playback_source``
(reference: src/LTE-Tracker.cpp:833-866): calibrated AWGN of
``noise_power`` drawn from ``np.random.default_rng(seed)``, then the
rtl_sdr re-quantization; the recording loops forever.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from benchmark.sim.raw import iq_to_bytes

BLOCK_SIZE = 10000


def playback(sig: np.ndarray, noise_power: float, seed: int
             ) -> Iterator[np.ndarray]:
    """uint8 IQ blocks of BLOCK_SIZE samples, looping over ``sig``."""
    rng = np.random.default_rng(seed)
    pos = 0
    while True:
        block = sig[pos:pos + BLOCK_SIZE]
        if len(block) < BLOCK_SIZE:
            block = np.concatenate([block, sig[:BLOCK_SIZE - len(block)]])
            pos = (pos + BLOCK_SIZE) % len(sig)
        else:
            pos += BLOCK_SIZE
        yield iq_to_bytes(block + (rng.standard_normal(len(block))
                                   + 1j * rng.standard_normal(len(block)))
                          * np.sqrt(noise_power / 2))
