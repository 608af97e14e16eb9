"""Tail-biting convolutional code, K=7, rate 1/3 (36.212 5.1.3.1).

Generators 0133 / 0171 / 0165 (octal, MSB = current input bit).
reference: src/lte_lib.cpp:520-551 which delegates to IT++'s
encode_tailbite / decode_tailbite; here both are implemented natively:

- encode: vectorized GF(2) convolution with the shift register preloaded
  with the last 6 input bits (tail-biting).
- decode: Viterbi over the 64-state trellis, run once from an all-equal
  start metric to obtain a per-start-state score is NOT sufficient for
  tail-biting; instead, like IT++, each possible start state is tried with
  the constraint end_state == start_state and the best metric wins. All 64
  hypotheses are evaluated in one vectorized trellis pass by carrying a
  (64 start, 64 current) metric matrix.

The batched device decoder (the same trellis, four steps fused per
pass) lives in models/viterbi.py; its tables are built here by
:func:`chain_tables`.
"""

from __future__ import annotations

import functools

import numpy as np

GENERATORS = (0o133, 0o171, 0o165)
K = 7
N_STATES = 64  # 2^(K-1)


def _gen_taps() -> np.ndarray:
    """(3, 7) binary tap matrix; taps[i][0] applies to the current bit."""
    taps = np.zeros((3, K), dtype=np.uint8)
    for i, g in enumerate(GENERATORS):
        for j in range(K):
            taps[i, j] = (g >> (K - 1 - j)) & 1
    return taps


def lte_conv_encode(c: np.ndarray) -> np.ndarray:
    """Tail-biting encode. Input (n,) bits; output (3, n) coded bits."""
    c = np.asarray(c, dtype=np.uint8) % 2
    n = len(c)
    taps = _gen_taps()
    # Tail-biting: prepend the last K-1 bits so the register starts loaded
    # with them; ext[j + t] for t=0..n-1 walks c[t-j] cyclically.
    ext = np.concatenate([c[-(K - 1):], c])
    d = np.zeros((3, n), dtype=np.uint8)
    for i in range(3):
        acc = np.zeros(n, dtype=np.uint8)
        for j in range(K):
            if taps[i, j]:
                acc ^= ext[K - 1 - j : K - 1 - j + n]
        d[i] = acc
    return d


@functools.lru_cache(maxsize=1)
def trellis() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Next-state table and output table for the 64-state trellis.

    Returns (next_state[state, bit], outputs[state, bit, 3], taps).
    State encodes the previous 6 input bits with state bit 5 = the most
    recent bit c_{k-1} and state bit 0 = the oldest bit c_{k-6}, so the
    transition is next = (state >> 1) | (bit << 5).
    """
    taps = _gen_taps()
    states = np.arange(N_STATES, dtype=np.int64)
    next_state = np.zeros((N_STATES, 2), dtype=np.int64)
    outputs = np.zeros((N_STATES, 2, 3), dtype=np.uint8)
    for bit in (0, 1):
        # register contents, most-recent first: [c_{k-1}..c_{k-6}]
        reg_bits = np.stack([(states >> (K - 2 - j)) & 1 for j in range(K - 1)], axis=1)
        full = np.concatenate([np.full((N_STATES, 1), bit, dtype=np.int64),
                               reg_bits], axis=1)  # [c_k, c_{k-1}, ..., c_{k-6}]
        for i in range(3):
            outputs[:, bit, i] = (full * taps[i]).sum(axis=1) % 2
        next_state[:, bit] = (states >> 1) | (bit << (K - 2))
    return next_state, outputs, taps


def lte_conv_decode(d_llr: np.ndarray) -> np.ndarray:
    """Tail-biting Viterbi decode.

    ``d_llr`` is (3, n) of ln(P(bit==0)/P(bit==1)) for each coded bit
    (the deratematcher's output). Returns the (n,) decoded bit vector.
    """
    d_llr = np.asarray(d_llr, dtype=np.float64)
    _, n = d_llr.shape
    next_state, outputs, _ = trellis()

    # Per-step branch metric for (state, bit): sum over the 3 coded bits of
    # +llr/2 when the coded bit is 0, -llr/2 when it is 1 (monotone in the
    # true log-likelihood; the 1/2 scale is irrelevant to the argmax).
    # signs[state, bit, i] in {+1, -1}
    signs = 1.0 - 2.0 * outputs.astype(np.float64)  # (64, 2, 3)

    # In this state convention (next = (state >> 1) | (bit << 5)) each next
    # state ns has exactly two predecessors 2*(ns & 31) and 2*(ns & 31) + 1,
    # reached with input bit ns >> 5.
    ns_all = np.arange(N_STATES)
    pred0 = 2 * (ns_all & 31)
    pred1 = pred0 + 1
    in_bit = (ns_all >> 5).astype(np.uint8)

    # Joint metric over (start_state, current_state). Start metric is 0 for
    # current == start, -inf elsewhere.
    metric = np.full((N_STATES, N_STATES), -np.inf)
    np.fill_diagonal(metric, 0.0)
    # Backpointers: (n, start, current) -> chosen predecessor state
    bp = np.zeros((n, N_STATES, N_STATES), dtype=np.uint8)

    for t in range(n):
        bm = signs @ d_llr[:, t]  # (64 state, 2 bit)
        m0 = metric[:, pred0] + bm[pred0, in_bit]
        m1 = metric[:, pred1] + bm[pred1, in_bit]
        take1 = m1 > m0
        metric = np.where(take1, m1, m0)
        bp[t] = np.where(take1, pred1, pred0).astype(np.uint8)

    # Tail-biting constraint: best (start == end) path.
    start = int(np.argmax(np.diagonal(metric)))

    # Traceback
    bits = np.zeros(n, dtype=np.uint8)
    state = start
    for t in range(n - 1, -1, -1):
        bits[t] = state >> 5  # the input bit that produced `state`
        state = bp[t, start, state]
    return bits


@functools.lru_cache(maxsize=1)
def _tables():
    """Branch signs (64, 2, 3), first predecessor (64,) and input bit (64,)
    of every next state (next = (state >> 1) | (bit << 5))."""
    next_state, outputs, _ = trellis()
    signs = (1.0 - 2.0 * outputs.astype(np.float32))      # (64, 2, 3)
    ns_all = np.arange(N_STATES)
    pred0 = (2 * (ns_all & 31)).astype(np.int32)          # (64,)
    in_bit = (ns_all >> 5).astype(np.int32)               # (64,)
    return signs, pred0, in_bit


@functools.lru_cache(maxsize=4)
def chain_tables(k: int):
    """k-step trellis chains.

    - the predecessor k steps back of state s along chain j is
      ``((s << k) & 63) | j``: the shift register drops s's top k bits
      and exposes the chain's k input bits as its low bits;
    - the k branch metrics' sum is LINEAR in the k*3 LLRs, so it is one
      (k*3, 64*2^k) matrix A of +-1 entries: add = llr_flat @ A.

    Also returns BITS (64, 2^k, k): the decoded input bits of chain j
    ending at s, in forward time order (for the traceback).
    """
    signs, pred0, in_bit = _tables()
    signs_flat = signs.reshape(2 * N_STATES, 3)           # (128, 3)
    A = np.zeros((k * 3, N_STATES * 2 ** k), np.float32)
    BITS = np.zeros((N_STATES, 2 ** k, k), np.int32)
    for s in range(N_STATES):
        for j in range(2 ** k):
            cur = s
            for i in range(k):              # walk back from the newest
                # chain j's input bits are the predecessor's low bits:
                # the bit consumed at walk-back step i is j's (k-1-i)-th.
                p = pred0[cur] + ((j >> (k - 1 - i)) & 1)
                step = k - 1 - i            # forward time within chunk
                A[step * 3:(step + 1) * 3, s * 2 ** k + j] += \
                    signs_flat[p * 2 + in_bit[cur]]
                BITS[s, j, step] = in_bit[cur]
                cur = p
            assert cur == ((s << k) & (N_STATES - 1)) | j
    return A, BITS
