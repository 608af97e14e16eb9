"""3GPP 36.211 Gold-sequence (length-31) pseudo-random generator.

reference: src/lte_lib.cpp:41-147 (lte_pn). The reference fast-forwards the
two 31-bit LFSRs by 1600 steps using hard-coded GF(2) matrices; here we keep
the state in a uint64 bitmask and step it with bitwise ops, vectorized over a
batch of c_init values (the RS table construction needs 60 sequences at
once), which is both simpler and faster than matrix powers at these lengths.

Recurrences (x = [x(n) .. x(n+30)], LSB = x(n)):
    x1(n+31) = x1(n+3) + x1(n)
    x2(n+31) = x2(n+3) + x2(n+2) + x2(n+1) + x2(n)
    c(n)     = x1(n+1600) + x2(n+1600)
"""

from __future__ import annotations

import functools

import numpy as np

_NC = 1600


# The LFSRs advance in 28-step blocks: because each step emits bit 0 and
# injects the new bit at position 30, the next 28 outputs are exactly the
# low 28 bits of the current state, and all 28 new bits depend only on the
# current 31 bits (max tap index 3 + 27 = 30). One vectorized iteration
# therefore replaces 28 scalar steps.
_CHUNK = 28
_MASK = np.uint64((1 << _CHUNK) - 1)
_BITS = np.arange(_CHUNK, dtype=np.uint64)


def _run_blocks(state: np.ndarray, n_chunks: int, taps) -> np.ndarray:
    """Emit n_chunks*28 bits from each LFSR state. taps = shift amounts
    whose XOR forms the feedback. Returns (B, n_chunks*28) uint8."""
    out = np.empty((len(state), n_chunks * _CHUNK), dtype=np.uint8)
    for k in range(n_chunks):
        out[:, k * _CHUNK:(k + 1) * _CHUNK] = (
            (state[:, None] >> _BITS) & np.uint64(1)).astype(np.uint8)
        new = state >> np.uint64(taps[0])
        for t in taps[1:]:
            new = new ^ (state >> np.uint64(t))
        state = (state >> np.uint64(_CHUNK)) \
            | ((new & _MASK) << np.uint64(31 - _CHUNK))
    return out


def lte_pn_batch(c_inits: np.ndarray, length: int) -> np.ndarray:
    """Generate Gold sequences for a batch of c_init seeds.

    Returns uint8 array of shape (len(c_inits), length).
    """
    c_inits = np.asarray(c_inits, dtype=np.uint64)
    total = _NC + length
    n_chunks = -(-total // _CHUNK)
    x1 = _run_blocks(np.array([1], dtype=np.uint64), n_chunks, (3, 0))[0]
    x2 = _run_blocks(c_inits.copy(), n_chunks, (3, 2, 1, 0))
    return (x1[_NC:total] ^ x2[:, _NC:total]).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _lte_pn_cached(c_init: int, length: int) -> np.ndarray:
    out = lte_pn_batch(np.array([c_init], dtype=np.uint64), length)[0]
    out.flags.writeable = False
    return out


def lte_pn(c_init: int, length: int) -> np.ndarray:
    """Gold sequence c(n), n = 0..length-1, for a single seed (cached,
    read-only)."""
    return _lte_pn_cached(int(c_init), int(length))
