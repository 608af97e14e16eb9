"""PyTorch port of the greedy peak search
(lte_cell_scanner_tpu_torch/ops/peak_torch.py) vs the JAX device search
(ops/peak_jax.py) and the host search (ops/peak.py): the same scan tables in,
exactly the same peak tables out. The plain loop (``peak_search_plain``,
which the wrapper takes for a CPU tensor) is also held to the JAX loop on
planted tables (tests/peak_cases.py): ties, NaN, a table that fills.
The ``peak_greedy`` kernel is held to the plain loop on the card in
tests/test_torch_peak_card.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lte_cell_scanner_tpu.constants import DS_COMB_ARM, THRESH1_N_NINES
from lte_cell_scanner_tpu.ops import peak_jax
from lte_cell_scanner_tpu.ops.peak import peak_search
from lte_cell_scanner_tpu.search.cell_search import detection_threshold
from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
from lte_cell_scanner_tpu_torch.ops import peak_torch
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import scan_plan, xcorr_core
import peak_cases
from torch_one_thread import _one_torch_thread  # noqa: F401


FC = 739e6


def _tables(cap, fset):
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    cap2 = torch.from_numpy(np.stack([cap.real, cap.imag]).astype(np.float32))
    packed, single, _ = xcorr_core(cap2, plan, DS_COMB_ARM)
    return packed, single.contiguous(), plan.n_comb_xc


def _compare(cap, fset):
    packed, single, n_comb_xc = _tables(cap, fset)
    r_norm = peak_torch.r_th1_normalized(n_comb_xc, DS_COMB_ARM,
                                         THRESH1_N_NINES)
    assert r_norm == peak_jax.r_th1_normalized(n_comb_xc, DS_COMB_ARM,
                                               THRESH1_N_NINES)
    got = peak_torch.peak_search_device(packed, single, r_norm,
                                        DS_COMB_ARM).numpy()
    want = np.asarray(peak_jax.peak_search_device(
        jnp.asarray(packed.numpy()), jnp.asarray(single.numpy()), r_norm,
        DS_COMB_ARM))
    np.testing.assert_array_equal(got, want)

    p = packed.numpy().astype(np.float64)
    host = peak_search(p[0:3], p[3:6].astype(np.int64),
                       detection_threshold(p[6], n_comb_xc), fset, FC, FC,
                       single.numpy().astype(np.float64), DS_COMB_ARM)
    cells = peak_torch.peaks_to_cells(got, fset, FC, FC)
    assert [(c.pss_pow, c.ind, c.freq, c.n_id_2) for c in cells] == \
        [(h.pss_pow, h.ind, h.freq, h.n_id_2) for h in host]
    return cells


def test_peaks_synthetic_capture():
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture

    cap = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=5.0,
                            freq_offset=7.7e3, n_subframes=30, seed=4)
    # A second, weaker cell on another PSS root.
    cap = cap + 0.5 * synthetic_capture(n_id_1=3, n_id_2=0, snr_db=None,
                                        freq_offset=-4e3, n_subframes=30,
                                        seed=5)
    cells = _compare(cap, np.arange(-3, 4) * 5e3)
    assert {c.n_id_2 for c in cells} >= {0, 1}


@pytest.mark.parametrize("kind", ["noise", "dead"])
def test_peaks_without_a_cell(kind):
    """All-noise and all-zero ("dead radio") captures: both searches stop
    at once (the all-zero table and threshold must not loop)."""
    rng = np.random.default_rng(9)
    n = 48000
    cap = np.zeros(n, complex) if kind == "dead" else (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    cells = _compare(cap, np.arange(-2, 3) * 5e3)
    assert cells == []


# Peaks each planted case yields (tests/peak_cases.py): the first pass's
# and, for a table that fills, the unbounded search's.
PLANTED = {"ties": (10, 10), "nan_row": (0, 0), "nan_refine": (10, 10),
           "dense": (64, 102), "noise": (0, 0)}


@pytest.mark.parametrize("kind", peak_cases.KINDS)
def test_plain_loop_matches_jax_on_planted_tables(kind):
    """Ties across rows and lags (first flat index), the -8 dB cut at its
    exact edge, the cyclic window across the wrap, ties and a NaN in the
    refinement window, a NaN pow row, a table that fills 64 slots and is
    redone at PEAK_BOUND trips: the plain loop's tables equal the JAX
    loop's, and the redone table the JAX loop's at 102 trips."""
    packed, single = peak_cases.capture(kind, np.random.default_rng(11))
    p, s = torch.from_numpy(packed)[None], torch.from_numpy(single)[None]
    r_norm, arm = peak_cases.R_NORM, peak_cases.ARM
    assert r_norm == peak_torch.r_th1_normalized(peak_cases.N_COMB, arm)
    tables = {}
    for max_peaks in (peak_torch.MAX_PEAKS, peak_torch.PEAK_BOUND):
        got = peak_torch.peak_search_plain(p, s, r_norm, arm,
                                           max_peaks)[0].numpy()
        want = np.asarray(peak_jax.peak_search_device(
            jnp.asarray(packed), jnp.asarray(single), r_norm, arm,
            max_peaks=max_peaks))
        np.testing.assert_array_equal(got, want)
        tables[max_peaks] = got
    first = tables[peak_torch.MAX_PEAKS]
    assert (int((first[:, 0] > 0).sum()),
            int((tables[peak_torch.PEAK_BOUND][:, 0] > 0).sum())) \
        == PLANTED[kind]
    redone = peak_torch.redo_full_tables(first[None], p, s, r_norm, arm)[0]
    np.testing.assert_array_equal(
        redone, tables[peak_torch.PEAK_BOUND] if first[-1, 0] > 0 else first)


@pytest.mark.parametrize("stacked", [True, False])
def test_wrapper_takes_plain_loop_on_cpu(monkeypatch, stacked):
    """On CPU tensors peak_search_device runs peak_search_plain (one
    capture as a stack of one) and launches no kernel."""
    plain = peak_torch.peak_search_plain
    calls = []

    def spy(packed, *args):
        calls.append(tuple(packed.shape))
        return plain(packed, *args)

    monkeypatch.setattr(peak_torch, "peak_search_plain", spy)
    before = LAUNCHES["peak_greedy"]
    packed, single = peak_cases.stack(peak_cases.KINDS, 3)
    p, s = torch.from_numpy(packed), torch.from_numpy(single)
    args = (peak_cases.R_NORM, peak_cases.ARM)
    if stacked:
        got = peak_torch.peak_search_device(p, s, *args)
        want = plain(p, s, *args, peak_torch.MAX_PEAKS)
    else:
        got = peak_torch.peak_search_device(p[0], s[0], *args)
        want = plain(p[:1], s[:1], *args, peak_torch.MAX_PEAKS)[0]
    assert calls == [(len(packed) if stacked else 1, 7, 9600)]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert LAUNCHES["peak_greedy"] == before
