"""PyTorch port of the greedy peak search
(lte_cell_scanner_tpu_torch/ops/peak_torch.py) vs the JAX device search
(ops/peak_jax.py) and the host search (ops/peak.py): the same scan tables in,
exactly the same peak tables out.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lte_cell_scanner_tpu.constants import DS_COMB_ARM, THRESH1_N_NINES
from lte_cell_scanner_tpu.ops import peak_jax
from lte_cell_scanner_tpu.ops.peak import peak_search
from lte_cell_scanner_tpu.search.cell_search import detection_threshold
from lte_cell_scanner_tpu_torch.ops import peak_torch
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import scan_plan, xcorr_core
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
