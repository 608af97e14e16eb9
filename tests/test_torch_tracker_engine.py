"""The port's batched tracker engine (lte_cell_scanner_tpu_torch/tracker/,
device="cpu": the kernels' plain versions) vs the JAX package's batch
engine: per-cell tables, host planners, the demod and stats programs, the
packed fetch format, the searcher and the tracker end to end.

Tolerances: tables and float64 host code agree exactly; float32 program
outputs within rtol 1e-5 + atol 1e-5 * max (matrix products summed in
another order); float16-packed lanes within one float16 step (rtol 1e-3 +
atol 1e-3 * max: two float32 values a few ulp apart may round to
neighbouring float16 values); end to end the same cells and MIB decodes,
the global FO within 2 Hz and the frame timing within 0.1 samples (the
bounds of tests/test_batch_tracker.py for two data planes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_cell_scanner_tpu.tracker import batch_runtime as jbr
from lte_cell_scanner_tpu.tracker.runtime import LTETracker as JaxTracker
from lte_cell_scanner_tpu.tracker.searcher import \
    searcher_pass as jax_searcher_pass
from lte_cell_scanner_tpu.tracker.state import GlobalState as JaxState
from lte_cell_scanner_tpu.tracker.state import TrackedCell as JaxCell
from lte_cell_scanner_tpu_torch.constants import CAPLENGTH
from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq, iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.tracker import batch_runtime as br
from lte_cell_scanner_tpu_torch.tracker import cli
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)
from lte_cell_scanner_tpu_torch.tracker.searcher import searcher_pass
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell
from torch_one_thread import _one_torch_thread  # noqa: F401

F16 = dict(rtol=1e-3, atol_rel=1e-3)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


@pytest.fixture(scope="module")
def sim_signal():
    # tests/test_batch_tracker.py::sim_signal
    return synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                             freq_offset=4e3, n_subframes=400,
                             sfn_start=0, seed=5)


# (signal, initial FO, blocks, cell): the runs of tests/test_batch_tracker.py
# test_batch_engine_matches_host_tracker and test_batch_engine_extended_cp.
CASES = {
    "normal": (dict(n_id_1=90, n_id_2=1, snr_db=15, freq_offset=4e3,
                    n_subframes=400, sfn_start=0, seed=5), 4000.0, 300, 271),
    "extended": (dict(n_id_1=44, n_id_2=2, cp_type="extended", snr_db=15,
                      freq_offset=-3e3, n_subframes=400, sfn_start=4,
                      seed=9), -3000.0, 400, 134),
}


def _tapped(slot, sym):
    """The CE tap's symbols: RS-bearing and plain symbols of slots that
    no other consumer reads (not sync, not PBCH), so that the tap adds
    interpolation consumers to the engine."""
    return slot in (3, 13) and sym in (0, 2, 4)


@pytest.fixture(scope="module", params=sorted(CASES))
def trackers(request):
    """The port's tracker on the CPU and the JAX batch engine, both fed
    the same blocks of a simulated cell, both with the same CE tap
    (``ce_observer``) recording into ``.taps``; returns (port, ref, cell
    id)."""
    sig_kw, fo, blocks, n_id = CASES[request.param]
    sig = synthetic_capture(**sig_kw)
    taps = [], []
    port = LTETracker(739e6, initial_freq_offset=fo, device="cpu",
                      ce_observer=(_tapped,
                                   lambda *a: taps[0].append(a)))
    ref = JaxTracker(739e6, initial_freq_offset=fo, batch=True,
                     ce_observer=(_tapped, lambda *a: taps[1].append(a)))
    port.taps, ref.taps = taps
    port.run(playback_source(sig), max_blocks=blocks)
    ref.run(playback_source(sig), max_blocks=blocks)
    return port, ref, n_id


# ---------------------------------------------------------------------------
# Tables and host planners.


@pytest.mark.parametrize("n_id,n_ports,cp", [(271, 1, "normal"),
                                             (134, 2, "extended"),
                                             (503, 4, "normal")])
def test_cell_ctx_tables_match_jax(n_id, n_ports, cp):
    kw = dict(n_id_cell=n_id, n_ports=n_ports, cp_type=cp, n_rb_dl=50,
              phich_duration="normal", phich_resource=1.0, frame_timing=0.0)
    got, want = br._CellCtx(TrackedCell(**kw)), jbr._CellCtx(JaxCell(**kw))
    for name in ("rs_tab", "shift_tab", "pss_conj", "sss0", "sss10", "scr"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_host_helpers_exact():
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(4)
    targets = rng.standard_normal((150, 4))
    alphas = rng.uniform(1e-4, 0.9, (150, 4))
    np.testing.assert_array_equal(br._iir_chain(x0, targets, alphas),
                                  jbr._iir_chain(x0, targets, alphas))
    for s in range(6):
        np.testing.assert_array_equal(br._interp72_mat(s),
                                      jbr._interp72_mat(s))
    for args in [("normal", 0, 0, 3), ("normal", 1, 4, 5),
                 ("extended", 2, 3, 4), ("normal", 3, 1, 7)]:
        assert br._a_value(*args) == jbr._a_value(*args)


def test_pack_bytes_match_jax():
    """The single-fetch f16 buffer, with float32 lanes bit-cast to pairs
    of f16 lanes, has the same bytes as the JAX engine's."""
    rng = np.random.default_rng(4)
    plain = rng.standard_normal((5, 3)).astype(np.float32)
    plain[0] = [1e5, -1e-8, -0.0]             # f16 overflow, underflow
    lossless = (rng.standard_normal(7) * 1e3).astype(np.float32)
    lossless[:3] = [np.inf, -0.0, 1.0001234]
    got = br._pack(torch.from_numpy(plain), ("f32", torch.from_numpy(lossless)))
    want = jbr._pack(jnp.asarray(plain), ("f32", jnp.asarray(lossless)))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy().view(np.uint16),
                                  np.asarray(want).view(np.uint16))
    p2, l2 = br._unpack(got.numpy(), [(5, 3), ("f32", (7,))])
    np.testing.assert_array_equal(l2, lossless.astype(np.float64))


# ---------------------------------------------------------------------------
# Device programs.


def _demod_case(quantized):
    # The seeded case of tests/test_fd_demod_pallas.py::
    # test_engine_pallas_stream_path_matches_xla.
    rng = np.random.default_rng(19)
    C, S, R, Q, K, P = 2, 16, 4, 4, 2, 2
    seg = rng.integers(0, 256, size=(4096, 2), dtype=np.uint8)
    starts = rng.integers(0, 4096 - 256, size=(C, S)).astype(np.int32)
    foc = rng.normal(scale=1e-3, size=(C, S)).astype(np.float32)
    bpo = rng.uniform(-np.pi, np.pi, size=(C, S)).astype(np.float32)
    late = rng.uniform(-2, 2, size=(C, S)).astype(np.float32)
    rs_conj_tab = rng.normal(size=(C, 20, 2, 12, 2)).astype(np.float32)
    shift_tab = rng.integers(0, 6, size=(C, 20, 2, P)).astype(np.int32)
    rs_idx = rng.integers(0, S, size=(C, R)).astype(np.int32)
    rs_slot = rng.integers(0, 20, size=(C, R)).astype(np.int32)
    rs_sym = rng.integers(0, 2, size=(C, R)).astype(np.int32)
    keep_idx = rng.integers(0, S, size=(C, Q)).astype(np.int32)
    pair_idx = np.sort(
        rng.integers(0, S, size=(C, K, 2)).astype(np.int32), axis=-1)
    pair_sel = rng.integers(0, 2, size=(C, K)).astype(np.int32)
    pss_conj = rng.normal(size=(C, 62, 2)).astype(np.float32)
    sss_tab = rng.choice([-1.0, 1.0], size=(C, 2, 62)).astype(np.float32)
    if quantized:      # the engine's i16 plan lanes
        bpo = np.round(bpo * (65536.0 / (2.0 * np.pi))).astype(np.int16)
        late = np.round(late * 8192.0).astype(np.int16)
    args = (seg, starts, foc, bpo, late, rs_conj_tab, shift_tab, rs_idx,
            rs_slot, rs_sym, keep_idx, pair_idx, pair_sel, pss_conj, sss_tab)
    return args, (C, Q, K)


@pytest.mark.parametrize("quantized", [False, True])
def test_demod_program_matches_jax(quantized):
    args, (C, Q, K) = _demod_case(quantized)
    t_args = [torch.from_numpy(a) for a in args]
    for i in (6, 7, 8, 9, 10, 11, 12):           # index lanes
        t_args[i] = t_args[i].long()
    flat, ce = br._demod_stream(*t_args)
    jflat, jce = jbr._demod_stream_jit(*(jnp.asarray(a) for a in args))
    _close(ce, jce)
    shapes = [(C, Q, 72, 2), (C, K), (C, K), (C, K), (C, K), (C, 62, 2)]
    for g, w in zip(br._unpack(flat.numpy(), shapes),
                    jbr._unpack(jflat, shapes)):
        _close(g, w, **F16)


def _stats_case(R=10):
    """The stats program's seeded arguments (before n_seg) for C = 2 cells
    of P = 2 ports and R RS rows each, and (C, P, T, E)."""
    rng = np.random.default_rng(23)
    C, P, T, E = 2, 2, 30, 7
    Cp, n_rows = C * P, C * P * 2 + C * R * P
    base = rng.standard_normal((12, 2))
    ce_dev = (base + 0.3 * rng.standard_normal((C, R, P, 12, 2))
              ).astype(np.float32)
    carry_vals = (base + 0.3 * rng.standard_normal((C, P, 2, 12, 2))
                  ).astype(np.float32)
    tri = rng.integers(0, n_rows, (T, 3))
    pl = rng.integers(0, 2, T).astype(bool)
    seg_id = rng.integers(0, C + 1, T)
    emit_idx = rng.integers(0, T, E)
    carry_idx = rng.integers(0, n_rows, (C, P, 2))
    td_rows = rng.integers(0, n_rows, (Cp, 72))
    td_new = np.array([0, 5, 72, 40])
    td0_rows = rng.integers(0, n_rows, (Cp, 72))
    td0_new = np.array([3, 72, 0, 40])
    td0_sp = rng.integers(0, T, Cp)
    td_hist = rng.standard_normal((Cp, 72, 12, 2)).astype(np.float32)
    args = (ce_dev, carry_vals, tri, pl, seg_id, emit_idx, carry_idx,
            td_rows, td_new, td0_rows, td0_new, td0_sp, td_hist)
    return args, (C, P, T, E)


def test_stats_program_matches_jax():
    args, (C, P, T, E) = _stats_case()
    Cp = C * P
    flat, new_h = br._stats(*(torch.from_numpy(a) for a in args), C + 1)
    jflat, jnew_h = jbr._stats_jit(*(jnp.asarray(a) for a in args),
                                   n_seg=C + 1)
    np.testing.assert_array_equal(new_h.numpy(), np.asarray(jnew_h))
    shapes = [("f32", (T,)), ("f32", (T,)), ("f32", (T,)), ("f32", (T,)),
              (E, 12, 2), (E, 4), ("f32", (C + 1, 12, 2)),
              ("f32", (C + 1, 12)), (C, P, 2, 12, 2), (Cp, 72, 2)]
    for sh, g, w in zip(shapes, br._unpack(flat.numpy(), shapes),
                        jbr._unpack(jflat, shapes)):
        _close(g, w) if sh[0] == "f32" else _close(g, w, **F16)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("n_seg", [4, 9])
@pytest.mark.parametrize("width", [(), (12, 2)])
def test_segment_sum_bits(n_seg, width):
    """The capture-safe _segment_sum (counts by scatter_add_, unchecked
    segment_reduce) gives the bits of the bincount form it replaced, on
    random unsorted segment ids; with 9 segments some stay empty. Exact."""
    rng = np.random.default_rng(31 + n_seg)
    T = 200
    x = torch.from_numpy(rng.standard_normal((T, *width)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, min(n_seg, 6), T))
    got = br._segment_sum(x, seg, n_seg)
    order = torch.sort(seg, stable=True).indices
    want = torch.segment_reduce(x[order], "sum", axis=0,
                                lengths=torch.bincount(seg, minlength=n_seg))
    assert got.shape == want.shape == (n_seg, *width)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("demod_fn", ["_demod_stream", "_demod_samples"])
def test_recorded_cycle_replays_bit_equal(demod_fn):
    """bench_tracker's tap records one cycle's programs as the engine
    calls them (by their module-level names); the eager replay of the
    recorded cycle (demod, stats on the replayed CE rows, the MIB decode)
    gives the tapped results to the bit on the CPU, and the device bound
    is empty there."""
    from lte_cell_scanner_tpu_torch.tools import bench_tracker as bt

    args, (C, Q, K) = _demod_case(True)
    t_args = [torch.from_numpy(a) for a in args]
    for i in (6, 7, 8, 9, 10, 11, 12):           # index lanes
        t_args[i] = t_args[i].long()
    if demod_fn == "_demod_samples":
        rng = np.random.default_rng(5)
        S = t_args[1].shape[1]
        t_args = [torch.from_numpy(rng.integers(
            0, 256, (C, S, 128, 2), dtype=np.uint8))] + t_args[2:]
    s_args, _ = _stats_case(R=4)
    s_args = [torch.from_numpy(a) for a in s_args[1:]]
    llr = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (5, 3, 40)).astype(np.float32))
    originals = {name: getattr(br, name) for name in bt.PROGRAMS}
    with bt.ProgramTap() as tap:
        flat, ce = getattr(br, demod_fn)(*t_args)
        br._stats(ce, *s_args, C + 1)
        br.lte_conv_decode_batch(llr)
    assert {name: getattr(br, name) for name in bt.PROGRAMS} == originals
    assert tap.counts == {"cycles": 1, "mib": 1}
    rec = bt.recorded_cycle(tap)
    assert rec["demod_fn"] == demod_fn
    got = bt.replay_cycle(rec)
    got.update(bt.replay_mib(rec))
    want = bt.tapped_results(rec)
    assert sorted(got) == sorted(want) == ["ce", "demod", "stats",
                                           "td_hist", "vit"]
    assert bt.same_bits(got, want)
    assert bt.device_bound(tap, cells=C, cycle_signal_s=0.3) == {}


# ---------------------------------------------------------------------------
# Searcher and end to end.


@pytest.mark.parametrize("tracked", [set(), {271}])
def test_searcher_pass_matches_jax(sim_signal, tracked):
    """The port's searcher (its device cell search with the one global-FO
    hypothesis) finds the same cells as the JAX package's host chain."""
    cap = bytes_to_iq(iq_to_bytes(sim_signal[7000:7000 + CAPLENGTH]))
    got = searcher_pass(cap, GlobalState(739e6, 739e6, 1.92e6, 4000.0),
                        tracked, device="cpu")
    want = jax_searcher_pass(cap, JaxState(739e6, 739e6, 1.92e6, 4000.0),
                             tracked)
    fields = ("n_ports", "cp_type", "n_rb_dl")
    assert [(c.n_id_cell(), *(getattr(c, f) for f in fields)) for c in got] \
        == [(c.n_id_cell(), *(getattr(c, f) for f in fields)) for c in want]
    assert len(got) == (0 if tracked else 1)
    for g, w in zip(got, want):
        assert abs(g.frame_start - w.frame_start) < 1e-6


def test_tracker_matches_jax_engine(trackers):
    port, ref, n_id = trackers
    ps, rs = port.status(), ref.status()
    assert len(ps["cells"]) == len(rs["cells"]) == 1
    pc, rc = ps["cells"][0], rs["cells"][0]
    for key in ("n_id_cell", "n_ports", "cp_type", "n_rb_dl", "health",
                "mib_successes"):
        assert pc[key] == rc[key], key
    assert pc["n_id_cell"] == n_id and pc["mib_successes"] > 10
    assert abs(ps["frequency_offset"] - rs["frequency_offset"]) < 2.0
    d_ft = (pc["frame_timing"] - rc["frame_timing"] + 9600) % 19200 - 9600
    assert abs(d_ft) < 0.1


def test_tracker_measurements_match_jax(trackers):
    """The sync/CRS measurement averages and the AC diagnostics, which
    cross the f16 fetch, agree with the JAX engine's."""
    p, r = trackers[0].cells[0], trackers[1].cells[0]
    for name in ("sync_sp_av", "sync_np_av", "sync_tp_av", "crs_tp_av",
                 "crs_np_av"):
        np.testing.assert_allclose(getattr(p, name), getattr(r, name),
                                   rtol=1e-3, err_msg=name)
    for name in ("ac_fd", "ac_td", "ce"):
        a, b = getattr(p, name), getattr(r, name)
        assert a is not None and b is not None, name
        assert np.abs(a - b).max() < 1e-3 * np.abs(b).max(), name


def test_ce_tap_matches_jax(trackers):
    """The CE tap sees the same symbols, in order, as the JAX engine's,
    with the same interpolated CE, SP and NP (interpolated from rows that
    crossed the float16 fetch: within one float16 step)."""
    port, ref, n_id = trackers
    assert len(port.taps) > 20
    assert [t[:3] for t in port.taps] == [t[:3] for t in ref.taps]
    assert {t[0] for t in port.taps} == {n_id}
    assert {(t[1], t[2]) for t in port.taps} == {
        (s, y) for s in (3, 13) for y in (0, 2, 4)}
    for i in (3, 4, 5):
        got = np.stack([t[i] for t in port.taps])
        want = np.stack([t[i] for t in ref.taps])
        _close(got.real, want.real, **F16)
        _close(got.imag, want.imag, **F16)
    assert port.taps[0][3].shape == (port.cells[0].n_ports, 72)


def test_td_align_matches_jax():
    """Re-keying the device-resident ac_td history to a new cell set
    (a cell dropped, one retained at another position, one new) moves the
    same rows and counts as the JAX engine."""
    def cell(mod, n_id):
        return mod(n_id_cell=n_id, n_ports=2, cp_type="normal", n_rb_dl=50,
                   phich_duration="normal", phich_resource=1.0,
                   frame_timing=0.0)

    rng = np.random.default_rng(5)
    H = rng.standard_normal((4, 72, 12, 2)).astype(np.float32)
    count = np.array([3, 80, 72, 5])
    results = []
    for mod, eng, put in (
            (TrackedCell, br.BatchTrackerEngine(
                GlobalState(739e6, 739e6, 1.92e6), device="cpu"),
             torch.from_numpy),
            (JaxCell, jbr.BatchTrackerEngine(JaxState(739e6, 739e6, 1.92e6)),
             jnp.asarray)):
        a, b, c = cell(mod, 10), cell(mod, 20), cell(mod, 30)
        work = [(a, []), (b, [])]
        eng._td_align(work, 2, 2)
        eng._td["H"], eng._td["count"] = put(H), count.copy()
        eng._td_align([(b, []), (c, [])], 2, 2)
        results.append((np.asarray(eng._td["H"]), eng._td["count"]))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])
    np.testing.assert_array_equal(results[0][0][:2], H[2:])
    assert not results[0][0][2:].any()


def test_tracker_cli_on_cpu(capsys):
    assert cli.main(["-f", "739e6", "--simulate", "--blocks", "200",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[cell_acquired]" in out
    assert any(line.split()[:1] == ["271"] for line in out.splitlines())


def test_default_device_needs_cuda(monkeypatch):
    """device=None means the CUDA card: without one the tracker and its
    CLI raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LTETracker(739e6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-f", "739e6", "--simulate", "--blocks", "1"])
