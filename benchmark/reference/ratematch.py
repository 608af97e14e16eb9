"""Rate matching for convolutionally coded transport channels (36.212 5.1.4.2).

reference: src/lte_lib.cpp:409-518. Instead of the reference's "probe with
complex indices" trick, the (row, col) origin of every rate-matched bit is
computed directly as an integer index map, built once per (n_c, n_e) pair.
"""

from __future__ import annotations

import functools

import numpy as np

# 32-column subblock interleaver permutation (36.212 table 5.1.4-2).
PERM_PATTERN = np.array([
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
])


@functools.lru_cache(maxsize=16)
def _index_map(n_c: int, n_e: int) -> np.ndarray:
    """(n_e, 2) array: rate-matched bit k came from d[row[k], col[k]]."""
    n_cols = 32
    n_r = -(-n_c // n_cols)  # ceil
    pad = n_r * n_cols - n_c

    # For each of the 3 streams, interleave the column indices (with -1 as
    # the <NULL> padding marker).
    w = []
    cols = np.concatenate([np.full(pad, -1, dtype=np.int64),
                           np.arange(n_c, dtype=np.int64)])
    y = cols.reshape(n_r, n_cols)
    y_perm = y[:, PERM_PATTERN]
    v = y_perm.T.reshape(-1)  # column-wise read-out
    for r in range(3):
        w.append(np.stack([np.full(n_r * n_cols, r, dtype=np.int64), v], axis=1))
    # Bit collection: interleave the three streams stream-major like
    # cvectorize(transpose(v)) in the reference: w = [v0[0], v1[0], v2[0],
    # v0[1], ...]? No: cvectorize(transpose(v)) reads transpose(v) (which is
    # (n_r*n_c, 3)) column-major, i.e. all of stream 0, then stream 1, then
    # stream 2.
    w = np.concatenate(w, axis=0)  # (3 * n_r * n_cols, 2)

    # Selection with cyclic wrap, skipping <NULL> entries.
    valid = w[w[:, 1] >= 0]
    n_valid = len(valid)  # == 3 * n_c
    reps = -(-n_e // n_valid)
    sel = np.tile(valid, (reps, 1))[:n_e]
    return sel


def lte_conv_ratematch(d: np.ndarray, n_e: int) -> np.ndarray:
    """Rate-match a (3, n_c) coded block to n_e values."""
    d = np.asarray(d)
    idx = _index_map(d.shape[1], n_e)
    return d[idx[:, 0], idx[:, 1]]


def lte_conv_deratematch(e_llr: np.ndarray, n_c: int) -> np.ndarray:
    """Invert rate matching on LLRs ln(P0/P1): average repeated observations.

    Returns a (3, n_c) LLR matrix.
    reference: src/lte_lib.cpp:469-518.
    """
    e_llr = np.asarray(e_llr, dtype=np.float64)
    idx = _index_map(n_c, len(e_llr))
    d = np.zeros((3, n_c))
    count = np.zeros((3, n_c), dtype=np.int64)
    np.add.at(d, (idx[:, 0], idx[:, 1]), e_llr)
    np.add.at(count, (idx[:, 0], idx[:, 1]), 1)
    # Average (positions observed more than once), leave single hits as-is.
    d = np.where(count > 1, d / np.maximum(count, 1), d)
    return d
