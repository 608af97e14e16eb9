"""LTE modulation mapping and soft demodulation (36.211 7.1).

reference: src/lte_lib.cpp:559-634. Constellations follow the 36.211 bit
ordering; ``lte_demodulate`` returns exact per-bit LLRs ln(P(b==0)/P(b==1))
assuming the channel has been removed and each symbol carries complex noise
of power ``np`` (reference scales by 1/sqrt(np) then runs IT++'s soft
demodulator with N0=1 — identical likelihoods).
"""

from __future__ import annotations

import functools

import numpy as np

_QPSK_RE = np.array([1, 1, -1, -1], dtype=np.float64)
_QPSK_IM = np.array([1, -1, 1, -1], dtype=np.float64)
_QAM16_RE = np.array([1, 1, 3, 3, 1, 1, 3, 3, -1, -1, -3, -3, -1, -1, -3, -3], dtype=np.float64)
_QAM16_IM = np.array([1, 3, 1, 3, -1, -3, -1, -3, 1, 3, 1, 3, -1, -3, -1, -3], dtype=np.float64)
_QAM64_RE = np.array([
    3, 3, 1, 1, 3, 3, 1, 1, 5, 5, 7, 7, 5, 5, 7, 7,
    3, 3, 1, 1, 3, 3, 1, 1, 5, 5, 7, 7, 5, 5, 7, 7,
    -3, -3, -1, -1, -3, -3, -1, -1, -5, -5, -7, -7, -5, -5, -7, -7,
    -3, -3, -1, -1, -3, -3, -1, -1, -5, -5, -7, -7, -5, -5, -7, -7,
], dtype=np.float64)
_QAM64_IM = np.array([
    3, 1, 3, 1, 5, 7, 5, 7, 3, 1, 3, 1, 5, 7, 5, 7,
    -3, -1, -3, -1, -5, -7, -5, -7, -3, -1, -3, -1, -5, -7, -5, -7,
    3, 1, 3, 1, 5, 7, 5, 7, 3, 1, 3, 1, 5, 7, 5, 7,
    -3, -1, -3, -1, -5, -7, -5, -7, -3, -1, -3, -1, -5, -7, -5, -7,
], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def constellation(modulation: str) -> np.ndarray:
    """Symbol table indexed by the bit pattern (first bit = MSB)."""
    if modulation == "qpsk" or modulation == "qam":
        return (_QPSK_RE + 1j * _QPSK_IM) / np.sqrt(2.0)
    if modulation == "qam16":
        return (_QAM16_RE + 1j * _QAM16_IM) / np.sqrt(10.0)
    if modulation == "qam64":
        return (_QAM64_RE + 1j * _QAM64_IM) / np.sqrt(42.0)
    raise ValueError(f"unknown modulation {modulation!r}")


def bits_per_symbol(modulation: str) -> int:
    return {"qpsk": 2, "qam": 2, "qam16": 4, "qam64": 6}[modulation]


def lte_modulate(bits: np.ndarray, modulation: str = "qpsk") -> np.ndarray:
    bits = np.asarray(bits, dtype=np.int64) % 2
    bps = bits_per_symbol(modulation)
    if len(bits) % bps:
        raise ValueError("bit count not a multiple of bits/symbol")
    idx = bits.reshape(-1, bps) @ (1 << np.arange(bps - 1, -1, -1))
    return constellation(modulation)[idx]


def lte_demodulate(syms: np.ndarray, noise_pow: np.ndarray,
                   modulation: str = "qpsk") -> np.ndarray:
    """Exact per-bit LLR ln(P(b==0)/P(b==1)).

    ``noise_pow`` is the complex noise power of each symbol (scalar or
    per-symbol vector). Output is interleaved bit-major within each symbol:
    [b0(sym0), b1(sym0), ..., b0(sym1), ...].
    """
    syms = np.asarray(syms)
    noise_pow = np.broadcast_to(np.asarray(noise_pow, dtype=np.float64), syms.shape)
    bps = bits_per_symbol(modulation)

    if modulation in ("qpsk", "qam"):
        # Closed form: LLR = 2*sqrt(2)*Re/np, 2*sqrt(2)*Im/np.
        out = np.empty(syms.size * 2)
        out[0::2] = 2.0 * np.sqrt(2.0) * syms.real / noise_pow
        out[1::2] = 2.0 * np.sqrt(2.0) * syms.imag / noise_pow
        return out

    table = constellation(modulation)
    # Exact log-sum-exp over the constellation.
    # dist2: (n_syms, n_points)
    dist2 = np.abs(syms[:, None] - table[None, :]) ** 2 / noise_pow[:, None]
    ll = -dist2
    out = np.empty(syms.size * bps)
    idx = np.arange(len(table))
    from scipy.special import logsumexp
    for b in range(bps):
        bit = (idx >> (bps - 1 - b)) & 1
        l0 = logsumexp(ll[:, bit == 0], axis=1)
        l1 = logsumexp(ll[:, bit == 1], axis=1)
        out[b::bps] = l0 - l1
    return out
