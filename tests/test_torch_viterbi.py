"""PyTorch port of the tail-biting Viterbi decoder
(lte_cell_scanner_tpu_torch/models/viterbi.py, plain version on the CPU) vs
the JAX Pallas kernel K5 in interpret mode and the host decoder
(models/convcode.py): decoded bits equal exactly.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lte_cell_scanner_tpu.models.convcode import (lte_conv_decode,
                                                  lte_conv_encode)
from lte_cell_scanner_tpu.models.convcode_jax import _chain_tables
from lte_cell_scanner_tpu.models.viterbi_pallas import \
    lte_conv_decode_pallas_tl
from lte_cell_scanner_tpu_torch.models.convcode import chain_tables
from lte_cell_scanner_tpu_torch.models.viterbi import (lte_conv_decode_batch,
                                                       sign_mask, viterbi_tl,
                                                       viterbi_tl_plain)
from torch_one_thread import _one_torch_thread  # noqa: F401


KINDS = ("random", "encoded")
# Integer LLRs in {-2..2}: many equal path metrics, so every tie rule of
# the decoder (branch argmax, start argmax) is exercised.
TIE_KIND = "ties"


def _to_tl(d_llr):
    """(B, 3, 40) -> the kernel's time-major (10, 12, B) layout."""
    B = d_llr.shape[0]
    return np.ascontiguousarray(np.transpose(
        np.moveaxis(d_llr, 1, 2).reshape(B, 10, 12), (1, 2, 0)))


def _llrs(kind, B=40, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((B, 3, 40)).astype(np.float32) * 3
    if kind == TIE_KIND:
        return rng.integers(-2, 3, (B, 3, 40)).astype(np.float32)
    bits = rng.integers(0, 2, (B, 40))
    coded = np.stack([lte_conv_encode(b) for b in bits]).astype(np.float64)
    # Encoded BPSK plus noise at a few SNRs (some codewords fail to decode
    # to the sent bits; the decoders must still agree).
    sigma = np.linspace(0.3, 1.5, B)[:, None, None]
    llr = (1 - 2 * coded) + sigma * rng.standard_normal(coded.shape)
    return (2 * llr / sigma ** 2).astype(np.float32)


def test_chain_tables_match_jax():
    a, bits = chain_tables(4)
    a_ref, bits_ref = _chain_tables(4)
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(bits, bits_ref)


def test_sign_mask_is_chain_tables_signs():
    """The kernel's sign table: bit k of entry p is set exactly where
    chain_tables(4)'s A[k, p] is -1, and A is +-1, so flipping the LLR's
    sign bit is A * l bit for bit."""
    a, _ = chain_tables(4)
    mask = sign_mask(a)
    assert mask.shape == (1024,) and mask.dtype == np.int32
    bits = (mask[None, :] >> np.arange(12)[:, None]) & 1
    np.testing.assert_array_equal(bits == 1, a < 0)
    np.testing.assert_array_equal(np.abs(a), 1)
    llr = np.random.default_rng(3).standard_normal(12).astype(np.float32)
    llr[:2] = 0.0
    flipped = (llr.view(np.uint32)[:, None]
               ^ (bits.astype(np.uint32) << 31)).view(np.float32)
    np.testing.assert_array_equal(flipped.view(np.uint32),
                                  (a * llr[:, None]).view(np.uint32))


@pytest.fixture(scope="module")
def pallas_bits():
    """Every kind's codewords (120 lanes) through ONE interpret-mode
    kernel tile (the interpreter is slow)."""
    kinds = KINDS + (TIE_KIND,)
    tl = np.concatenate([_to_tl(_llrs(k)) for k in kinds], axis=2)
    tl_pad = np.zeros((10, 12, 128), np.float32)
    tl_pad[:, :, :tl.shape[2]] = tl
    out = np.asarray(lte_conv_decode_pallas_tl(jnp.asarray(tl_pad),
                                               interpret=True))
    B = tl.shape[2] // len(kinds)
    return {k: out[:, i * B:(i + 1) * B] for i, k in enumerate(kinds)}


@pytest.mark.parametrize("kind", KINDS)
def test_viterbi_matches_pallas_and_host(kind, pallas_bits):
    d_llr = _llrs(kind)
    got = viterbi_tl(torch.from_numpy(_to_tl(d_llr))).numpy()   # (40, B)
    np.testing.assert_array_equal(got, pallas_bits[kind])

    host = np.stack([lte_conv_decode(d.astype(np.float64)) for d in d_llr])
    np.testing.assert_array_equal(got.T, host)
    np.testing.assert_array_equal(
        lte_conv_decode_batch(torch.from_numpy(d_llr)).numpy(), host)


def test_viterbi_ties_match_pallas(pallas_bits):
    """The tie-heavy integer LLRs decode to the Pallas kernel's bits."""
    tl = torch.from_numpy(_to_tl(_llrs(TIE_KIND)))
    got = viterbi_tl(tl).numpy()
    np.testing.assert_array_equal(got, pallas_bits[TIE_KIND])
    np.testing.assert_array_equal(got, viterbi_tl_plain(tl).numpy())
