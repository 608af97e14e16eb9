"""The ``peak_greedy`` kernel (lte_cell_scanner_tpu_torch/csrc/
peak_greedy.cu, launched by ops/peak_torch.py::peak_search_device) against
its plain version (``peak_search_plain``) on the card, to the bit.

At B = 1, 121 and 271 captures and at 64 and 102 (PEAK_BOUND) trips: on
the planted tables of tests/peak_cases.py (ties, NaN, a table that fills)
and on scan tables of a stack of simulator captures and noise (K1 over
the stack, the fold's strided ``single``). Each launch is followed by
``torch.cuda.synchronize()``, which brings a fault in the kernel to light.

Marked ``card``; skipped without one. This file imports no JAX, so it runs
on the card with ``python -m pytest --noconftest -m card
tests/test_torch_peak_card.py``.
"""

import functools

import numpy as np
import pytest
import torch

import peak_cases
from lte_cell_scanner_tpu_torch.constants import DS_COMB_ARM
from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
from lte_cell_scanner_tpu_torch.ops.peak_torch import (
    MAX_PEAKS, PEAK_BOUND, peak_search_device, peak_search_plain,
    r_th1_normalized)

SIZES = (1, 121, 271)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_bits(packed, single, r_norm, arm):
    """The kernel's tables at both trip counts equal the plain loop's bit
    for bit; returns the first pass's peak counts."""
    for max_peaks in (MAX_PEAKS, PEAK_BOUND):
        before = LAUNCHES["peak_greedy"]
        got = peak_search_device(packed, single, r_norm, arm, max_peaks)
        torch.cuda.synchronize()
        assert LAUNCHES["peak_greedy"] == before + 1
        want = peak_search_plain(packed, single, r_norm, arm, max_peaks)
        assert got.shape == want.shape == (len(packed), max_peaks, 4)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        if max_peaks == MAX_PEAKS:
            counts = (want[:, :, 0] > 0).sum(dim=1).cpu()
    return counts


@pytest.mark.card
@pytest.mark.parametrize("B", SIZES)
def test_kernel_equals_plain_on_planted_tables(card, B):
    kinds = [peak_cases.KINDS[b % len(peak_cases.KINDS)] for b in range(B)]
    packed, single = peak_cases.stack(kinds, 20 + B)
    p = torch.from_numpy(packed).to(card)
    s = torch.from_numpy(single).to(card)
    counts = _same_bits(p, s, peak_cases.R_NORM, peak_cases.ARM)
    assert counts[0] == 10
    if B > 1:
        assert counts.max() == MAX_PEAKS and counts.min() == 0
    # One capture as (7, 9600): each kind alone.
    for b in range(min(B, len(peak_cases.KINDS))):
        got = peak_search_device(p[b], s[b], peak_cases.R_NORM,
                                 peak_cases.ARM)
        torch.cuda.synchronize()
        want = peak_search_plain(p[b:b + 1], s[b:b + 1], peak_cases.R_NORM,
                                 peak_cases.ARM)[0]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@functools.lru_cache(maxsize=1)
def _captures():
    """Three simulated cells (normal and extended CP, two roots) and a
    noise capture, complex128, 80 ms at 1.92 Msps."""
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture

    rng = np.random.default_rng(5)
    n = 153600
    return (synthetic_capture(n_id_1=90, n_id_2=1, snr_db=10.0, seed=3),
            synthetic_capture(n_id_1=167, n_id_2=2, cp_type="extended",
                              snr_db=5.0, freq_offset=-4e3, seed=4),
            synthetic_capture(n_id_1=3, n_id_2=0, snr_db=0.0,
                              freq_offset=2.5e3, seed=6),
            (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3)


@pytest.mark.card
@pytest.mark.parametrize("B", SIZES)
def test_kernel_equals_plain_on_scan_tables(card, B):
    from lte_cell_scanner_tpu_torch.ops.xcorr_torch import xcorr_core_batch
    from lte_cell_scanner_tpu_torch.parallel import fc_sweep
    from lte_cell_scanner_tpu_torch.search.cell_search import \
        generate_search_sets

    caps = _captures()
    # Every eighth carrier holds a cell, the first always; the rest noise.
    pick = [(b // 8) % 3 if b % 8 == 0 else 3 for b in range(B)]
    stack = np.stack([np.stack([caps[k].real, caps[k].imag])
                      for k in pick]).astype(np.float32)
    cap = torch.from_numpy(stack).to(card)
    fcs = [739e6 + 100e3 * b for b in range(B)]
    _, fset = generate_search_sets(739e6, 739e6, 120)
    banks, bank_idx, starts, n_comb, n_sp = fc_sweep.scan_inputs(
        fcs, fcs, fset, 1.92e6, stack.shape[2], card)
    packed, single = xcorr_core_batch(cap, banks, bank_idx, starts, n_comb,
                                      n_sp, DS_COMB_ARM)
    assert not single.is_contiguous()       # the fold's view
    counts = _same_bits(packed, single,
                        r_th1_normalized(n_comb, DS_COMB_ARM), DS_COMB_ARM)
    assert counts[0] > 0
