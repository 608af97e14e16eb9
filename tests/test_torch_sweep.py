"""The port's batched fc sweep (parallel/fc_sweep.py), its pipeline
(search/pipeline.py) and the stacked-capture planners and scan, against
the JAX package's sweep on three simulator captures at 739.0/739.1/739.2
MHz (the second on the E4000 tuner's programmed carrier), on the CPU
(device="cpu": the kernels' plain versions).

Tolerances: peak tables exact in (n_id_2, ind, freq), pss_pow within rtol
1e-5 (float32 scans summed in other orders); decoded IDs, CP, n_rb_dl,
ports, SFN and PHICH exact; freq_superfine within 0.5 Hz (as the JAX
package's tests/test_sharding.py allows); the planners' plans and the
pipeline's cells exactly equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.ops import mib_jax, sync_jax
from lte_cell_scanner_tpu.parallel import fc_sweep as jax_sweep
from lte_cell_scanner_tpu_torch.io.capture import compute_fc_programmed
from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.ops import (mib_torch, peak_torch,
                                            sync_torch, xcorr_torch)
from lte_cell_scanner_tpu_torch.ops.peak import peak_search
from lte_cell_scanner_tpu_torch.parallel import fc_sweep
from lte_cell_scanner_tpu_torch.search import cli
from lte_cell_scanner_tpu_torch.search.cell_search import cell_search
from lte_cell_scanner_tpu_torch.search.pipeline import pipelined_search_sweep
from lte_cell_scanner_tpu_torch.utils.device import device_planes, flat_stack
from torch_one_thread import _one_torch_thread  # noqa: F401

FSET = np.arange(-2, 3) * 5e3
FCS = [739.0e6, 739.1e6, 739.2e6]
FCP = [FCS[0], compute_fc_programmed(28.8e6, FCS[1]) + 58, FCS[2]]
CELLS = [(271, "normal", 50), (90, "normal", 75), (503, "extended", 100)]
DECODED = ("n_id_2", "n_id_1", "cp_type", "n_rb_dl", "n_ports", "sfn",
           "phich_duration", "phich_resource")


@pytest.fixture(scope="module")
def caps():
    return np.stack([
        synthetic_capture(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10,
                          freq_offset=7.7e3, n_rb_dl=50, seed=3),
        # tests/test_sharding.py:152's second capture.
        synthetic_capture(n_id_1=30, n_id_2=0, snr_db=15, freq_offset=6e3,
                          n_rb_dl=75, seed=7),
        synthetic_capture(n_id_1=167, n_id_2=2, cp_type="extended",
                          snr_db=10, freq_offset=-4e3, n_rb_dl=100, seed=3),
    ])


@pytest.fixture(scope="module")
def planes_u8(caps):
    """The captures as the radio's uint8 I/Q planes (B, 2, n)."""
    return np.stack([iq_to_bytes(0.3 * c).reshape(-1, 2).T for c in caps])


@pytest.fixture(scope="module")
def whole_stack(planes_u8):
    return fc_sweep.sharded_search_sweep(planes_u8, FCS, FSET, device="cpu",
                                         fc_prog_list=FCP)


def _same_peaks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) >= 1
        assert [(a.n_id_2, a.ind, a.freq) for a in g] == \
            [(a.n_id_2, a.ind, a.freq) for a in w]
        np.testing.assert_allclose([a.pss_pow for a in g],
                                   [a.pss_pow for a in w], rtol=1e-5)


@pytest.mark.parametrize("form", ["complex", "uint8"])
def test_fc_sweep_matches_jax(caps, planes_u8, form):
    x = caps if form == "complex" else planes_u8
    got = fc_sweep.sharded_fc_sweep(x, FCS, FSET, device="cpu",
                                    fc_prog_list=FCP)
    want = jax_sweep.sharded_fc_sweep(x, FCS, FSET, jax_sweep.make_cap_mesh(1),
                                      use_pallas=False, fc_prog_list=FCP)
    _same_peaks(got, want)


def test_fc_sweep_share_banks_matches_jax_pallas(planes_u8):
    """share_banks against the JAX TEA Pallas sweep (interpret mode) with
    share_banks; carriers with one fold schedule share one bank."""
    got = fc_sweep.sharded_fc_sweep(planes_u8, FCS, FSET, device="cpu",
                                    fc_prog_list=FCP, share_banks=True)
    want = jax_sweep.sharded_fc_sweep(planes_u8, FCS, FSET,
                                      jax_sweep.make_cap_mesh(1),
                                      use_pallas=True, fc_prog_list=FCP,
                                      share_banks=True)
    _same_peaks(got, want)
    sigs = {fc_sweep._bank_signature(fc, fp, FSET, 1.92e6, 15, True)[2]
            for fc, fp in zip(FCS, FCP)}
    # One cache entry per sweep and mesh: here one shard's (banks, idx).
    ((banks, bank_idx),), = [v for k, v in fc_sweep._DEV_BANK_CACHE.items()
                             if k[0] == tuple(FCS) and k[-1]]
    assert banks.shape[0] == len(sigs) < len(FCS)
    assert bank_idx.tolist()[0] == 0


def test_fc_sweep_table_full_fallback_matches_jax(caps):
    """max_peaks=1: every first-pass table is full, so every capture's
    table is redone on its device at PEAK_BOUND trips; the peaks equal the
    JAX package's, whose fallback is its unbounded host search over a
    float64 rescan."""
    got = fc_sweep.sharded_fc_sweep(caps, FCS, FSET, device="cpu",
                                    fc_prog_list=FCP, max_peaks=1)
    want = jax_sweep.sharded_fc_sweep(caps, FCS, FSET,
                                      jax_sweep.make_cap_mesh(1),
                                      use_pallas=False, fc_prog_list=FCP,
                                      max_peaks=1)
    _same_peaks(got, want)
    assert all(len(g) >= 2 for g in got)


def test_full_table_redo_is_unbounded_search():
    """A capture with PEAK_BOUND peaks (34 per PSS row, 275 lags apart,
    all within 12 dB) fills the first pass's table; host_tables redoes it
    at PEAK_BOUND trips and finds every peak, exactly as the port's
    unbounded host search does, and leaves a sparse capture's table as it
    was."""
    rng = np.random.default_rng(5)
    n_f, ds = 3, 2
    packed = np.zeros((2, 7, 9600), np.float32)
    for r in range(3):
        lags = r * 91 + 275 * np.arange(34)
        packed[0, r, lags] = rng.uniform(1.0, 1.5, 34)
        packed[0, 3 + r] = rng.integers(0, n_f, 9600)
    packed[1, 1, [100, 4000, 9000]] = [2.0, 1.5, 1.2]
    packed[:, 6] = 1e-6
    single = rng.uniform(0.0, 1.0, (2, 3, 9600, n_f)).astype(np.float32)
    packed, single = torch.from_numpy(packed), torch.from_numpy(single)
    r_norm = peak_torch.r_th1_normalized(15, ds)
    first = peak_torch.peak_search_device(packed, single, r_norm, ds)
    scan = fc_sweep.StackScan(first, packed, single, r_norm, ds)
    tables = scan.host_tables()
    assert (first[0, :, 0] > 0).all()
    fset = np.arange(n_f) * 5e3
    got = peak_torch.peaks_to_cells(tables[0], fset, FCS[0], FCS[0])
    p = packed[0].numpy().astype(np.float64)
    want = peak_search(p[0:3], p[3:6].astype(np.int64),
                       np.full(9600, 1e-9), fset, FCS[0], FCS[0],
                       single[0].numpy().astype(np.float64), ds)
    assert len(got) == peak_torch.PEAK_BOUND == 102
    assert [(c.pss_pow, c.ind, c.freq, c.n_id_2) for c in got] == \
        [(c.pss_pow, c.ind, c.freq, c.n_id_2) for c in want]
    np.testing.assert_array_equal(tables[1], first[1].numpy())


def test_fc_bank_is_scan_plans_bank():
    for fc, fp in zip(FCS, FCP):
        plan = xcorr_torch.scan_plan(153600, FSET, fc, fp, 1.92e6)
        np.testing.assert_array_equal(
            fc_sweep._fc_bank(fc, fp, FSET.tobytes(), 1.92e6), plan.tpl)


def test_search_sweep_matches_jax_and_cell_search(caps, planes_u8,
                                                  whole_stack):
    per_cap, deduped = whole_stack
    want, want_d = jax_sweep.sharded_search_sweep(
        planes_u8, FCS, FSET, jax_sweep.make_cap_mesh(1), fc_prog_list=FCP)
    for b, cells in enumerate(per_cap):
        assert [(c.n_id_cell(), c.cp_type, c.n_rb_dl) for c in cells] == \
            [CELLS[b]]
        for ref in (want[b], cell_search(
                fc_sweep._to_complex(planes_u8, b), FCS[b], FCP[b],
                f_search_set=FSET, interp="freq_time", device="cpu")):
            assert len(ref) == len(cells)
            for g, w in zip(cells, ref):
                assert [getattr(g, f) for f in DECODED] == \
                    [getattr(w, f) for f in DECODED]
                assert abs(g.freq_superfine - w.freq_superfine) < 0.5
    assert [c.n_id_cell() for c in deduped] == \
        [c.n_id_cell() for c in want_d] == [271, 90, 503]


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_pipeline_equals_whole_stack(planes_u8, whole_stack, batch):
    """Chunks of one capture, chunks of 2 (a short last chunk), and a sweep
    shorter than one chunk: Cell for Cell equal to the whole stack."""
    per_cap, deduped = pipelined_search_sweep(
        planes_u8, FCS, FSET, device="cpu", batch=batch, fc_prog_list=FCP)
    assert per_cap == whole_stack[0]
    assert deduped == whole_stack[1]


def test_plans_with_cap_bases_match_jax(planes_u8):
    """sync_plan and mib_plan of a 3-capture stack equal the JAX plans
    (integer fields exact, float fields at 0 ulp), and every window sits
    inside its own capture: the stacked plan is the one-capture plan
    moved by the base."""
    n_cap = planes_u8.shape[2]
    peaks = fc_sweep.sharded_fc_sweep(planes_u8, FCS, FSET, device="cpu",
                                      fc_prog_list=FCP)
    cells = [c for p in peaks for c in p]
    bases = [b * n_cap for b, p in enumerate(peaks) for _ in p]
    mine = sync_torch.sync_plan(cells, n_cap, bases)
    ref = sync_jax.sync_plan(cells, n_cap, 0.0, 0.0, 0.0, bucket=False,
                             cap_bases=bases)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(mine, f.name),
                                      getattr(ref, f.name), err_msg=f.name)
    base = np.asarray(bases)
    single = sync_torch.sync_plan(cells, n_cap)
    for f in ("pss_idx", "foe_pss", "foe_sss"):
        shape = (-1,) + (1,) * (getattr(mine, f).ndim - 1)
        mask = (single.rep_mask if f == "pss_idx" else single.foe_mask) > 0
        np.testing.assert_array_equal(
            getattr(mine, f)[mask],
            (getattr(single, f) + base.reshape(shape))[mask], err_msg=f)

    flat = flat_stack(device_planes(planes_u8, "cpu"))
    synced = sync_torch.sss_foe_batch(cells, flat, 3.0, n_cap=n_cap,
                                      cap_bases=bases)
    for cp in ("normal", "extended"):
        grp = [(c, b) for c, b in zip(synced, bases)
               if c.n_id_1 >= 0 and c.cp_type == cp]
        assert grp
        g_cells, g_bases = [c for c, _ in grp], [b for _, b in grp]
        mine = mib_torch.mib_plan(g_cells, n_cap, g_bases)
        ref = mib_jax.mib_plan(g_cells, n_cap, 0.0, 0.0, 0.0, bucket=False,
                               cap_bases=g_bases)
        for f in dataclasses.fields(ref):
            if f.name != "cells":
                np.testing.assert_array_equal(getattr(mine, f.name),
                                              getattr(ref, f.name),
                                              err_msg=f.name)
        assert mine.ok.all()
        np.testing.assert_array_equal(mine.base, g_bases)
        # A grid that runs past its own capture fails, though the stack
        # goes on: ok is checked against one capture's length.
        late = [dataclasses.replace(c, frame_start=c.frame_start + 3 * 19200.0)
                for c in g_cells]
        assert not mib_torch.mib_plan(late, n_cap, g_bases).ok.any()


def test_xcorr_fold_batch_plain_equals_loop():
    """The batched scan's plain version is the one-capture plain version
    in a loop, banks picked by index (repeated here); the batched full
    scan equals the one-capture scan capture by capture."""
    rng = np.random.default_rng(0)
    n_cap, fset = 30000, np.arange(-1, 2) * 5e3
    cap = torch.from_numpy(rng.standard_normal((3, 2, n_cap)).astype(
        np.float32))
    plans = [xcorr_torch.scan_plan(n_cap, fset, fc, fc, 1.92e6)
             for fc in (739e6, 745e6)]
    n_comb = min(p.n_comb_xc for p in plans)
    bank = torch.from_numpy(np.stack([p.tpl for p in plans]))
    bank_idx = torch.tensor([1, 0, 1], dtype=torch.int32)
    starts = torch.from_numpy(np.stack([plans[i].starts[:, :n_comb]
                                        for i in (1, 0, 1)]))
    got = xcorr_torch.xcorr_fold_batch(cap, bank, bank_idx, starts, n_comb)
    for b, i in enumerate((1, 0, 1)):
        want = xcorr_torch.xcorr_fold_plain(cap[b], bank[i], starts[b],
                                            n_comb)
        assert torch.equal(got[b], want.view(3, 3, -1).permute(1, 2, 0))
    packed, single = xcorr_torch.xcorr_core_batch(
        cap, bank, bank_idx, starts, n_comb, plans[0].n_comb_sp, 2)
    assert torch.equal(single, got)
    for b, i in enumerate((1, 0, 1)):
        plan = dataclasses.replace(plans[i], starts=starts[b].numpy(),
                                   n_comb_xc=n_comb)
        want, _, _ = xcorr_torch.xcorr_core(cap[b], plan, 2)
        assert torch.equal(packed[b], want)


def test_sweep_needs_cuda(monkeypatch, planes_u8):
    """device=None means the CUDA card: without one the sweeps and the
    CLI's batched sweep raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (fc_sweep.sharded_fc_sweep, fc_sweep.sharded_search_sweep,
                pipelined_search_sweep):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(planes_u8, FCS, FSET)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--freq-start", "739e6", "--freq-end", "745.3e6",
                  "--simulate", "--batch-sweep", "--sweep-batch", "32"])
