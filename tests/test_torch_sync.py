"""PyTorch port of the batched SSS detection + fine FOE
(lte_cell_scanner_tpu_torch/ops/sync_torch.py) vs the JAX device program
(ops/sync_jax.py): the same JAX plan goes to both programs, so the test
isolates the device math; the port's own planner must give the JAX plan.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lte_cell_scanner_tpu.constants import DS_COMB_ARM, THRESH2_N_SIGMA
from lte_cell_scanner_tpu.ops import sync_jax
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.ops import sync_torch
from lte_cell_scanner_tpu_torch.ops.peak_torch import (peak_search_device,
                                                       peaks_to_cells,
                                                       r_th1_normalized)
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import scan_plan, xcorr_core
from torch_one_thread import _one_torch_thread  # noqa: F401


FC = 739e6
FIELDS = ("n_id_1", "cp_sel", "ord_sel", "detected", "dfreq")


def _peaks(cap, fset):
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    cap2 = torch.from_numpy(np.stack([cap.real, cap.imag]).astype(np.float32))
    packed, single, _ = xcorr_core(cap2, plan, DS_COMB_ARM)
    table = peak_search_device(packed, single, r_th1_normalized(
        plan.n_comb_xc, DS_COMB_ARM), DS_COMB_ARM)
    return peaks_to_cells(table.numpy(), fset, FC, FC)


@pytest.mark.parametrize("n_subframes,cp_type,n_id_1,n_id_2,foff", [
    (80, "normal", 90, 1, 7.7e3),
    (80, "extended", 167, 2, -6e3),
    # Longer than 80 ms: the plan's repetition axis grows past 16
    # (the case of test_device_sync_long_capture_uses_all_reps).
    (120, "normal", 12, 1, 4e3),
])
def test_sync_matches_jax(n_subframes, cp_type, n_id_1, n_id_2, foff):
    cap = synthetic_capture(n_id_1=n_id_1, n_id_2=n_id_2, cp_type=cp_type,
                            snr_db=10.0, freq_offset=foff,
                            n_subframes=n_subframes, seed=2)
    peaks = _peaks(cap, np.arange(-2, 3) * 5e3)
    assert peaks
    n_cap = len(cap)
    plan = sync_jax.sync_plan(peaks, n_cap, FC, FC, 1.92e6)
    if n_subframes > 80:
        assert plan.rep_mask.shape[1] > 16
        assert plan.rep_mask[0, 16:].sum() > 0

    # The port's planner gives the JAX plan (unbucketed).
    mine = sync_torch.sync_plan(peaks, n_cap)
    ref = sync_jax.sync_plan(peaks, n_cap, FC, FC, 1.92e6, bucket=False)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(mine, f.name),
                                      getattr(ref, f.name), err_msg=f.name)

    cap32 = np.stack([cap.real, cap.imag], -1).astype(np.float32)
    got = sync_torch._sync_device(torch.from_numpy(cap32), plan,
                                  THRESH2_N_SIGMA)
    want = np.asarray(sync_jax._sync_device(
        jnp.asarray(cap32), plan.pss_idx, plan.rep_mask, plan.foc,
        plan.inv_fs, plan.n_id_2, plan.foe_pss, plan.foe_sss, plan.foe_mask,
        plan.foe_seq, plan.foe_phase, plan.foe_conv,
        np.float32(THRESH2_N_SIGMA)), dtype=np.float64)
    n = len(peaks)
    for i, name in enumerate(FIELDS):
        g = got[name].numpy().astype(np.float64)[:n]
        if name == "dfreq":
            # 1e-3 Hz, plus 1e-6 relative: dfreq is a float32 of a few
            # kHz, whose ulp alone is ~5e-4 Hz.
            np.testing.assert_allclose(g, want[i, :n], rtol=1e-6, atol=1e-3)
        else:
            np.testing.assert_array_equal(g, want[i, :n], err_msg=name)
    assert want[3, :n].any()                       # a peak was detected

    # The host-side unpacking: frame_start is picked from the f64 plan.
    cells = sync_torch.finish_sync_batch(
        sync_torch.SyncPending(got, plan, peaks))
    ref_cells = sync_jax.finish_sync_batch(sync_jax.SyncPending(
        jnp.asarray(want.astype(np.float32)), plan, peaks))
    for c, r in zip(cells, ref_cells):
        assert (c.n_id_1, c.cp_type, c.frame_start) == \
            (r.n_id_1, r.cp_type, r.frame_start)
    assert any(c.n_id_cell() == 3 * n_id_1 + n_id_2 and c.cp_type == cp_type
               for c in cells)


def test_sync_tables_match_jax():
    for name in ("_dft62", "_smooth13_mat", "_sss_tables", "_pss_fd_conj"):
        a, b = getattr(sync_torch, name)(), getattr(sync_jax, name)()
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    np.testing.assert_array_equal(sync_torch._CN62, sync_jax._CN62)
