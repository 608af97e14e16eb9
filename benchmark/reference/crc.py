"""LTE CRC calculation (36.212 5.1.1).

reference: src/lte_lib.cpp:637-663. Plain polynomial long division over
GF(2) with zero initial state; the MIB's CRC16 antenna-port mask is applied
by the caller (ops/pbch.py), as in the reference (src/searcher.cpp:1628-1636).
"""

from __future__ import annotations

import numpy as np

# Generator polynomials, MSB first, per 36.212 5.1.1.
_POLYS = {
    "crc8": [1, 1, 0, 0, 1, 1, 0, 1, 1],
    "crc16": [1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
    "crc24a": [1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1],
    "crc24b": [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1],
}


def lte_calc_crc(bits, crc: str = "crc16") -> np.ndarray:
    """Compute the CRC parity bits of a bit vector (uint8 0/1, MSB first)."""
    poly = np.asarray(_POLYS[crc.lower()], dtype=np.uint8)
    n_par = len(poly) - 1
    reg = np.concatenate([np.asarray(bits, dtype=np.uint8) % 2,
                          np.zeros(n_par, dtype=np.uint8)])
    for i in range(len(reg) - n_par):
        if reg[i]:
            reg[i:i + n_par + 1] ^= poly
    return reg[-n_par:].copy()
