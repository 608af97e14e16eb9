"""The port's multi-device paths on repeated CPU devices, against the
one-shard runs and the JAX package's sharded code on its virtual CPU
devices (conftest): the sweep's cap axis (parallel/fc_sweep.py
``CapMesh``, the pipeline, the wideband sweep), the (seq, hyp)-sharded
scan (parallel/sharded_search.py) and the multichip checks
(parallel/multichip_checks.py).

Tolerances:
- decoded IDs, CP, n_rb_dl, ports, SFN and PHICH exact;
- peak tables exact in (n_id_2, ind, freq); pss_pow exact against the
  port's one-shard run, within rtol 1e-5 against the JAX sweep (float32
  scans summed in other orders);
- freq_superfine: bit-equal (every field of every cell) against the
  port's one-shard runs of the sweep and the pipeline, which held; within
  the 0.5 Hz tests/test_torch_sweep.py allows against the JAX sweep and
  the one-shard wideband sweep (its channelizer convolves another count
  of carriers per shard);
- the sharded scan in float64: every table within atol 1e-12 of the JAX
  package's float64 ``xcorr_pss(..., backend="numpy")``, frq exact;
- the tracker engine cycle with its cell axis split over CPU shards
  (``check_tracker_cells_sharded``, whose own bound is the JAX check's):
  every field of both programs bit-equal to the one-device run, which
  held on the CPU.
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.ops.xcorr import xcorr_pss
from lte_cell_scanner_tpu.parallel import fc_sweep as jax_sweep
from lte_cell_scanner_tpu_torch.io.capture import compute_fc_programmed
from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.parallel import fc_sweep
from lte_cell_scanner_tpu_torch.parallel import multichip_checks as mc
from lte_cell_scanner_tpu_torch.parallel.sharded_search import (
    make_search_mesh, sharded_xcorr_pss)
from lte_cell_scanner_tpu_torch.search import cli
from lte_cell_scanner_tpu_torch.search import wideband as wb
from lte_cell_scanner_tpu_torch.search.pipeline import pipelined_search_sweep
from torch_one_thread import _one_torch_thread  # noqa: F401
from torch_wide import FC_CENTER, wide_two_cells

FSET = np.arange(-2, 3) * 5e3
# tests/test_torch_sweep.py's three captures, twice: six carriers, so that
# 2 and 3 shards both divide the sweep; every other one on the E4000
# tuner's programmed carrier.
FCS = [739.0e6 + 100e3 * i for i in range(6)]
FCP = [fc if i % 2 == 0 else compute_fc_programmed(28.8e6, fc) + 58
       for i, fc in enumerate(FCS)]
CELLS = [271, 90, 503] * 2


def cpus(n):
    return fc_sweep.CapMesh(["cpu"] * n)


@pytest.fixture(scope="module")
def planes_u8():
    caps = [
        synthetic_capture(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10,
                          freq_offset=7.7e3, n_rb_dl=50, seed=3),
        synthetic_capture(n_id_1=30, n_id_2=0, snr_db=15, freq_offset=6e3,
                          n_rb_dl=75, seed=7),
        synthetic_capture(n_id_1=167, n_id_2=2, cp_type="extended",
                          snr_db=10, freq_offset=-4e3, n_rb_dl=100, seed=3),
    ]
    return np.stack([iq_to_bytes(0.3 * c).reshape(-1, 2).T
                     for c in caps * 2])


@pytest.fixture(scope="module")
def one_shard(planes_u8):
    return fc_sweep.sharded_search_sweep(planes_u8, FCS, FSET, device="cpu",
                                         fc_prog_list=FCP)


def _peak_rows(peaks):
    return [[(c.n_id_2, c.ind, c.freq) for c in p] for p in peaks]


@pytest.mark.parametrize("n", [2, 3])
def test_cap_axis_sweep_matches_one_shard_and_jax(planes_u8, one_shard, n):
    per_cap, deduped = fc_sweep.sharded_search_sweep(
        planes_u8, FCS, FSET, cpus(n), fc_prog_list=FCP)
    assert [[c.n_id_cell() for c in p] for p in per_cap] == \
        [[c] for c in CELLS]
    assert per_cap == one_shard[0]          # every field bit-equal
    assert deduped == one_shard[1]
    want, want_d = jax_sweep.sharded_search_sweep(
        planes_u8, FCS, FSET, jax_sweep.make_cap_mesh(n), fc_prog_list=FCP)
    mc.same_cells(per_cap, want)
    assert sorted(c.n_id_cell() for c in deduped) == \
        sorted(c.n_id_cell() for c in want_d) == [90, 271, 503]


@pytest.mark.parametrize("n", [2, 3])
def test_cap_axis_fc_sweep_peaks(planes_u8, n):
    got = fc_sweep.sharded_fc_sweep(planes_u8, FCS, FSET, cpus(n),
                                    fc_prog_list=FCP)
    one = fc_sweep.sharded_fc_sweep(planes_u8, FCS, FSET, device="cpu",
                                    fc_prog_list=FCP)
    want = jax_sweep.sharded_fc_sweep(planes_u8, FCS, FSET,
                                      jax_sweep.make_cap_mesh(n),
                                      use_pallas=False, fc_prog_list=FCP)
    assert _peak_rows(got) == _peak_rows(one) == _peak_rows(want)
    assert [[c.pss_pow for c in p] for p in got] == \
        [[c.pss_pow for c in p] for p in one]
    np.testing.assert_allclose([c.pss_pow for p in got for c in p],
                               [c.pss_pow for p in want for c in p],
                               rtol=1e-5)


def test_sweep_fold_count_is_the_whole_sweeps():
    """Every shard folds the sweep's minimum count: here the second
    carrier's tuner (4,000 ppm off, so that its k_factor drift is large)
    leaves room for one fold fewer, which the first shard's carrier alone
    would not; the two-shard tables equal the one-shard and JAX ones."""
    n_cap = 38641                     # n_lags - 100 = 4 x 9600 + 5
    cap, fset, fc = mc.planted_capture(n_cap, 3)
    caps = np.stack([cap, cap])
    fcs, fcp = [fc, fc + 100e3], [fc, (fc + 100e3) * (1 - 4e-3)]
    got = fc_sweep.sharded_fc_sweep(caps, fcs, fset, cpus(2),
                                    fc_prog_list=fcp)
    one = fc_sweep.sharded_fc_sweep(caps, fcs, fset, device="cpu",
                                    fc_prog_list=fcp)
    alone = fc_sweep.sharded_fc_sweep(caps[:1], fcs[:1], fset,
                                      device="cpu", fc_prog_list=fcp[:1])
    want = jax_sweep.sharded_fc_sweep(caps, fcs, fset,
                                      jax_sweep.make_cap_mesh(2),
                                      use_pallas=False, fc_prog_list=fcp)
    assert got == one and len(got[0]) >= 1
    assert got[0][0].pss_pow != alone[0][0].pss_pow   # 3 folds, not 4
    assert _peak_rows(got) == _peak_rows(want)
    np.testing.assert_allclose([c.pss_pow for p in got for c in p],
                               [c.pss_pow for p in want for c in p],
                               rtol=1e-5)


@pytest.mark.parametrize("n,batch", [(2, 4), (3, 3)])
def test_pipeline_shards_equal_one_shard(planes_u8, one_shard, n, batch):
    """Chunks split over n shards (at 2 shards a short last chunk, whose
    second shard is empty) give the one-shard whole stack's cells."""
    per_cap, deduped = pipelined_search_sweep(
        planes_u8, FCS, FSET, cpus(n), batch=batch, fc_prog_list=FCP)
    assert per_cap == one_shard[0]
    assert deduped == one_shard[1]


def test_pipeline_small_sweep_keeps_shard_multiple(planes_u8):
    """A sweep smaller than the batch runs as one chunk rounded up to a
    shard multiple (tests/test_pipeline.py's case), dead or live."""
    dead = np.zeros((3, 2, 19200), np.uint8) + 127
    assert pipelined_search_sweep(dead, FCS[:3], np.array([0.0]), cpus(2),
                                  batch=32) == ([[], [], []], [])
    got = pipelined_search_sweep(planes_u8[:3], FCS[:3], FSET, cpus(2),
                                 batch=32, fc_prog_list=FCP[:3])
    want = fc_sweep.sharded_search_sweep(planes_u8[:3], FCS[:3], FSET,
                                         device="cpu", fc_prog_list=FCP[:3])
    assert got == want


def test_shards_must_divide(planes_u8):
    with pytest.raises(ValueError, match="not divisible"):
        fc_sweep.sharded_fc_sweep(planes_u8[:3], FCS[:3], FSET, cpus(2))
    with pytest.raises(ValueError, match="not divisible"):
        fc_sweep.sharded_search_sweep(planes_u8[:3], FCS[:3], FSET, cpus(2))
    with pytest.raises(ValueError, match="not divisible"):
        pipelined_search_sweep(planes_u8, FCS, FSET, cpus(2), batch=3)
    with pytest.raises(ValueError, match="must divide"):
        sharded_xcorr_pss(np.zeros(76800, complex), FSET[:3], 2, 739e6,
                          739e6, 1.92e6, make_search_mesh(
                              1, 2, devices=["cpu"] * 2),
                          dtype=np.float64)


def test_cuda_meshes_need_cuda(monkeypatch):
    """A mesh of CUDA devices raises without CUDA; nothing picks fewer
    shards or the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: fc_sweep.CapMesh(["cuda:0", "cuda:0"]),
                 lambda: fc_sweep.make_cap_mesh(1),
                 lambda: fc_sweep.all_cards_mesh(4),
                 lambda: make_search_mesh(1, 1),
                 lambda: make_search_mesh(1, 1, devices=["cuda:0"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert [fc_sweep.cap_shards(b, n) for b, n in
            ((64, 8), (6, 4), (7, 8), (296, 8), (5, 0))] == [8, 3, 7, 8, 1]


@pytest.mark.parametrize("n_seq,n_hyp", [(2, 1), (1, 2), (2, 2), (3, 1)])
def test_sharded_scan_matches_jax(n_seq, n_hyp):
    cap, fset, fc = mc.planted_capture(76800, 4)
    mesh = make_search_mesh(n_seq, n_hyp, devices=["cpu"] * (n_seq * n_hyp))
    out = sharded_xcorr_pss(cap, fset, 2, fc, fc, 1.92e6, mesh,
                            dtype=np.float64)
    ref = xcorr_pss(cap, fset, 2, fc, fc, 1.92e6, backend="numpy")
    mc.assert_scan_parity(out, ref)


def test_float32_scan_close_to_unsharded():
    """The float32 (seq 2, hyp 2) scan against the unsharded float32 scan
    (k1_scan), within SCAN_RTOL x max: the check dryrun_multichip makes
    on CUDA shards (here both take K1's plain version)."""
    cap, fset, fc = mc.planted_capture(76800, 4)
    out = sharded_xcorr_pss(cap, fset, 2, fc, fc, 1.92e6,
                            make_search_mesh(2, 2, devices=["cpu"] * 4))
    ref = mc.k1_scan(cap, fset, 2, fc, fc, 1.92e6, "cpu")
    assert mc.scan_close(out, ref) <= mc.SCAN_RTOL


def test_float64_scan_matches_jax():
    """The dryrun's float64 reference, at its production shape (153,600
    samples x 32 hypotheses), against the JAX package's host scan."""
    cap, fset, fc = mc.planted_capture(153600, 32)
    mc.assert_scan_parity(mc.float64_scan(cap, fset, 2, fc, fc, 1.92e6),
                          xcorr_pss(cap, fset, 2, fc, fc, 1.92e6,
                                    backend="numpy"))


@pytest.mark.parametrize("n", [2, 3])
def test_pipelined_sweep_multidevice_cpu(n):
    res = mc.check_pipelined_sweep_multidevice(n, devices=["cpu"] * n)
    assert res["cells"] >= 8 and res["bit_equal"]


@pytest.mark.parametrize("n,sizes", [(2, [8, 8]), (3, [6, 5, 5])])
def test_tracker_cells_split(n, sizes):
    """One real engine cycle of 16 cells split over 2 and (unevenly) 3
    CPU shards: both programs' outputs, unpacked field by field, equal the
    one-device run's bit for bit."""
    res = mc.check_tracker_cells_sharded(n, cells=16, devices=["cpu"] * n)
    assert res["cells"] == 16 and res["shards"] == sizes
    assert res["triples"] > 16 and res["bit_equal"]
    assert {f for f, (cnt, eq, _) in res["fields"].items()
            if cnt and cnt == eq} == set(mc.TRACKER_DEMOD) | set(
                mc.TRACKER_STATS) | {"ce", "td_hist"}
    assert not any(res["launches"].values())      # plain versions on CPU


def test_tracker_split_rebases_rows():
    """A shard's row indices: carry rows of its cells, then its CE rows;
    another shard's row is refused unless it is the placeholder 0."""
    C, R, P = 4, 3, 2
    n_car = C * P * 2
    g = np.array([0, 2 * P * 2 + 1, n_car + 2 * R * P + 5,
                  n_car + 3 * R * P])
    local, owned = mc._rebase_rows(g, 2, 4, C, R, P)
    assert owned.tolist() == [False, True, True, True]
    assert local.tolist() == [0, 1, 2 * P * 2 + 5, 2 * P * 2 + R * P]
    with pytest.raises(AssertionError, match="crosses shards"):
        mc._rebase_rows(np.array([n_car + 1]), 2, 4, C, R, P)


def test_dryrun_multichip_cpu():
    # Half the production capture, to keep the CPU run light; the float64
    # scan at 153,600 x 32 is held to JAX by test_float64_scan_matches_jax.
    res = mc.dryrun_multichip(4, devices=["cpu"] * 4, n_cap=76800)
    assert (res["seq"], res["hyp"], res["n_f"]) == (2, 2, 32)
    assert res["peak"][0] == 1 and res["pipelined"]["bit_equal"]
    assert res["tracker"]["shards"] == [2, 2, 2, 2]
    assert res["tracker"]["bit_equal"]


def test_wideband_sweep_shards():
    """Three carriers on three CPU shards, each channelizing its own
    carrier: the one-shard cells."""
    wide, fs_in = wide_two_cells()
    fcs = [FC_CENTER + 2.0e6, FC_CENTER - 1.5e6, FC_CENTER + 3.0e6]
    got, got_d = wb.wideband_search_sweep(wide, fs_in, FC_CENTER, fcs, FSET,
                                          cpus(3))
    want, want_d = wb.wideband_search_sweep(wide, fs_in, FC_CENTER, fcs,
                                            FSET, device="cpu")
    assert [[c.n_id_cell() for c in p] for p in got] == [[271], [90], []]
    mc.same_cells(got, want)
    assert [c.n_id_cell() for c in got_d] == [c.n_id_cell() for c in want_d]


def test_cli_prints_shard_count(capsys):
    assert cli.main(["--freq-start", "739e6", "--simulate", "--ppm", "5",
                     "--batch-sweep", "--device", "cpu"]) == 0
    assert "(single batch, 1 device shard(s))" in capsys.readouterr().out
