"""The port's host tracker data plane (``LTETracker(batch=False)``:
tracker/cell_tracker.py fed sample-carrying PDUs; ``backend="numpy"``: the
searcher and kalibrate on the float64 host chain) against the JAX
package's defaults, and the batched engine's sample-carrying mode.

Tolerances: the host data plane, the searcher, kalibrate and the feeders'
sample mode are copies of the JAX package's numpy code and agree to the
bit (events, status, CE taps, PDUs). The engine's sample-carrying demod
program agrees with the JAX engine's _demod_jit within rtol 1e-5 + atol
1e-5 * max (raw CE, float32) and one float16 step (packed lanes); against
the port's own descriptor mode on the same blocks, the same cells, MIB
decodes and taps, the CE and SP taps within one float16 step (the two
modes blend and ramp the same windows in another float32 order, and the
feedback loops carry the difference), the NP taps within 1% (a noise
power is the residual of CE values ~70x its size, so the subtraction
magnifies their relative difference), FO within 1e-3 Hz and frame timing
within 1e-3 samples.
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_cell_scanner_tpu.tracker import batch_runtime as jbr
from lte_cell_scanner_tpu.tracker import cli as jax_tracker_cli
from lte_cell_scanner_tpu.tracker.producer import \
    SampleFeeder as JaxSampleFeeder
from lte_cell_scanner_tpu.tracker.runtime import LTETracker as JaxTracker
from lte_cell_scanner_tpu.tracker.runtime import \
    playback_source as jax_playback
from lte_cell_scanner_tpu.tracker.searcher import kalibrate as jax_kalibrate
from lte_cell_scanner_tpu.tracker.searcher import \
    searcher_pass as jax_searcher_pass
from lte_cell_scanner_tpu.tracker.state import GlobalState as JaxState
from lte_cell_scanner_tpu.tracker.state import TrackedCell as JaxCell
from lte_cell_scanner_tpu_torch.constants import CAPLENGTH
from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq, iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.tracker import batch_runtime as br
from lte_cell_scanner_tpu_torch.tracker import cli
from lte_cell_scanner_tpu_torch.tracker.native_feeder import (
    NativeSampleFeeder)
from lte_cell_scanner_tpu_torch.tracker.producer import SampleFeeder
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)
from lte_cell_scanner_tpu_torch.tracker.searcher import (kalibrate,
                                                         searcher_pass)
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell
from test_torch_tracker_engine import F16, _close, _demod_case, _tapped
from torch_one_thread import _one_blas_thread, _one_torch_thread  # noqa: F401

FC = 739e6
BLOCKS = 200


@pytest.fixture(scope="module")
def sim_signal():
    # tests/test_tracker.py::sim_signal
    return synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                             freq_offset=4e3, n_subframes=400,
                             sfn_start=0, seed=5)


def _cell_kw(n_id=271, frame_timing=1234.5):
    return dict(n_id_cell=n_id, n_ports=1, cp_type="normal", n_rb_dl=50,
                phich_duration="normal", phich_resource=1.0,
                frame_timing=frame_timing)


def _cells(got, want):
    """Cell records of two packages, field by field."""
    return [vars(c) for c in got] == [vars(c) for c in want]


def test_state_updates_match_jax():
    st, jst = GlobalState(FC, FC, 1.92e6, 3000.0), JaxState(FC, FC, 1.92e6,
                                                            3000.0)
    c, jc = TrackedCell(**_cell_kw()), JaxCell(**_cell_kw())
    for est, est_np, delay in ((3100.0, 0.5, 0.3), (2950.0, 1e-4, -19199.0)):
        st.update_frequency_offset(est, est_np)
        jst.update_frequency_offset(est, est_np)
        c.update_frame_timing(delay, 0.01, 19100.0)
        jc.update_frame_timing(delay, 0.01, 19100.0)
        assert (st.frequency_offset, c.frame_timing) == \
            (jst.frequency_offset, jc.frame_timing)
    assert c.tracker_ready and jc.tracker_ready


def test_sample_feeder_sample_mode_matches_jax(sim_signal):
    """SampleFeeder(emit_descriptors=False) against the JAX package's
    default SampleFeeder(): every PDU's samples and metadata, and the
    searcher capture, equal."""
    feeders = [(SampleFeeder(GlobalState(FC, FC, 1.92e6, 4000.0),
                             emit_descriptors=False), TrackedCell),
               (JaxSampleFeeder(JaxState(FC, FC, 1.92e6, 4000.0)), JaxCell)]
    pdus = []
    for f, cls in feeders:
        cells = [cls(**_cell_kw(271, 1234.5)),
                 cls(**_cell_kw(134, 777.0))]
        cells[1].cp_type = "extended"
        f.request_searcher_capture()
        got, caps = [], []
        for raw in list(playback_source(sim_signal, repeat=False))[:40]:
            f.feed(bytes_to_iq(raw), cells)
            for c in cells:
                got += [(c.n_id_cell, p) for p in c.fifo]
                c.fifo.clear()
            cap = f.take_searcher_capture()
            if cap is not None:
                caps.append(cap)
        pdus.append((got, caps))
    (got, caps), (want, jcaps) = pdus
    assert len(got) == len(want) > 2000 and len(caps) == len(jcaps) == 1
    np.testing.assert_array_equal(caps[0], jcaps[0])
    for (n, p), (jn, jp) in zip(got, want):
        assert p.start is None and jp.start is None
        assert p.data.dtype == jp.data.dtype == np.complex128
        np.testing.assert_array_equal(p.data, jp.data)
        assert (n, p.slot_num, p.sym_num, p.late, p.frequency_offset,
                p.frame_timing) == (jn, jp.slot_num, jp.sym_num, jp.late,
                                    jp.frequency_offset, jp.frame_timing)


def test_native_feeder_sample_mode():
    """The C++ feeder with emit_descriptors=False (the same C function,
    descriptor mode 0): PDUs that carry the samples of the Python
    feeder's sample mode, bit for bit ((v - 127) / 128 is exact in
    float32), with late within 1e-6 (tests/test_torch_native_feeder.py's
    bound: the C++ clock adds the step every sample)."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++) to build native/feeder.cpp")
    rng = np.random.default_rng(3)
    raw = iq_to_bytes((rng.standard_normal(60000)
                       + 1j * rng.standard_normal(60000)) * 0.2)
    runs = []
    for f in (NativeSampleFeeder(GlobalState(FC, FC, 1.92e6, 4000.0),
                                 emit_descriptors=False),
              SampleFeeder(GlobalState(FC, FC, 1.92e6, 4000.0),
                           emit_descriptors=False)):
        cell = TrackedCell(**_cell_kw())
        for k in range(6):
            blk = raw[20000 * k:20000 * (k + 1)]
            if isinstance(f, NativeSampleFeeder):
                f.feed_bytes(blk, [cell])
            else:
                f.feed(bytes_to_iq(blk), [cell])
        runs.append(list(cell.fifo))
    na, py = runs
    assert len(na) == len(py) > 400
    for a, b in zip(na, py):
        assert a.start is None and b.start is None
        np.testing.assert_array_equal(a.data, b.data)
        assert (a.slot_num, a.sym_num) == (b.slot_num, b.sym_num)
        assert abs(a.late - b.late) <= 1e-6
    # The host data plane takes the C++ feeder in this mode.
    assert not LTETracker(FC, batch=False, backend="numpy",
                          feeder="native").feeder.emit_descriptors
    # Back to descriptor mode through the same property.
    f = NativeSampleFeeder(GlobalState(FC, FC, 1.92e6, 4000.0),
                           emit_descriptors=False)
    f.emit_descriptors = True
    cell = TrackedCell(**_cell_kw())
    f.feed_bytes(raw[:20000], [cell])
    assert cell.fifo and all(p.data is None and p.start is not None
                             for p in cell.fifo)


@pytest.mark.parametrize("tracked", [set(), {271}])
def test_searcher_pass_numpy_matches_jax(sim_signal, tracked):
    """searcher_pass(backend="numpy") is the JAX package's host searcher
    to the bit: a tracked ID is skipped before its MIB."""
    cap = bytes_to_iq(iq_to_bytes(sim_signal[7000:7000 + CAPLENGTH]))
    got = searcher_pass(cap, GlobalState(FC, FC, 1.92e6, 4000.0), tracked,
                        backend="numpy")
    want = jax_searcher_pass(cap, JaxState(FC, FC, 1.92e6, 4000.0),
                             tracked)
    assert _cells(got, want) and len(got) == (0 if tracked else 1)


def test_kalibrate_numpy_matches_jax(sim_signal):
    got = kalibrate(playback_source(sim_signal),
                    GlobalState(FC, FC, 1.92e6), ppm=10, backend="numpy")
    want = jax_kalibrate(jax_playback(sim_signal), JaxState(FC, FC, 1.92e6),
                         ppm=10)
    assert got == want and abs(got - 4000) < 20


def test_host_tracker_matches_jax_default(sim_signal):
    """LTETracker(batch=False, backend="numpy") against the JAX package's
    LTETracker() (its defaults): kalibrate, then BLOCKS blocks with a CE
    tap; events, status (but the searcher's wall time) and every tap
    equal to the bit."""
    runs = []
    for cls, src, kw in ((LTETracker, playback_source,
                          dict(batch=False, backend="numpy", device="cpu")),
                         (JaxTracker, jax_playback, {})):
        events, taps = [], []
        trk = cls(FC, on_event=lambda k, i: events.append((k, i)),
                  ce_observer=(_tapped, lambda *a: taps.append(a)), **kw)
        trk.kalibrate(src(sim_signal), ppm=10)
        trk.run(src(sim_signal, seed=1), max_blocks=BLOCKS)
        st = trk.status()
        st.pop("searcher_cycle_time")
        runs.append((events, st, taps, trk))
    (ev, st, taps, trk), (jev, jst, jtaps, _) = runs
    assert trk.engine is None and not trk.feeder.emit_descriptors
    assert ev == jev and [k for k, _ in ev] == ["kalibrate", "cell_acquired"]
    assert st == jst
    c = st["cells"][0]
    assert (c["n_id_cell"], c["health"]) == (271, 1.0)
    assert c["mib_successes"] > 10
    assert len(taps) == len(jtaps) > 100
    for t, jt in zip(taps, jtaps):
        assert t[:3] == jt[:3]
        for a, b in zip(t[3:], jt[3:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantized", [False, True])
def test_sample_demod_program_matches_jax(quantized):
    """The engine's demod program on sample-carrying windows (K4's stream
    mode over the windows laid end to end) against the JAX engine's
    _demod_jit on the same u8 windows and plan."""
    args, (C, Q, K) = _demod_case(quantized)
    S = args[1].shape[1]
    data = np.random.default_rng(5).integers(0, 256, size=(C, S, 128, 2),
                                             dtype=np.uint8)
    args = (data,) + args[2:]
    t_args = [torch.from_numpy(a) for a in args]
    for i in (5, 6, 7, 8, 9, 10, 11):            # index lanes
        t_args[i] = t_args[i].long()
    flat, ce = br._demod_samples(*t_args)
    jflat, jce = jbr._demod_jit(*(jnp.asarray(a) for a in args))
    _close(ce, jce)
    shapes = [(C, Q, 72, 2), (C, K), (C, K), (C, K), (C, K), (C, 62, 2)]
    for g, w in zip(br._unpack(flat.numpy(), shapes),
                    jbr._unpack(jflat, shapes)):
        _close(g, w, **F16)


def test_engine_sample_mode_matches_descriptor_mode(sim_signal):
    """The batched engine fed sample-carrying PDUs against the same engine
    fed descriptors, on the same blocks."""
    runs = []
    for desc in (True, False):
        taps = []
        trk = LTETracker(FC, initial_freq_offset=4000.0, device="cpu",
                         ce_observer=(_tapped, lambda *a: taps.append(a)))
        trk.feeder.emit_descriptors = desc
        trk.run(playback_source(sim_signal), max_blocks=BLOCKS)
        runs.append((trk.status(), taps))
        pdus_carry = [p.data is not None for c in trk.cells for p in c.fifo]
        assert not any(pdus_carry) if desc else all(pdus_carry)
    (st, taps), (sst, staps) = runs
    key = ("n_id_cell", "n_ports", "health", "mib_successes")
    assert [[c[k] for k in key] for c in st["cells"]] == \
        [[c[k] for k in key] for c in sst["cells"]] == \
        [[271, 1, 1.0, st["cells"][0]["mib_successes"]]]
    assert st["cells"][0]["mib_successes"] > 10
    assert abs(st["frequency_offset"] - sst["frequency_offset"]) < 1e-3
    assert abs(st["cells"][0]["frame_timing"]
               - sst["cells"][0]["frame_timing"]) < 1e-3
    assert [t[:3] for t in taps] == [t[:3] for t in staps]
    assert len(taps) > 100
    for i in (3, 4):                              # CE, SP
        _close(np.stack([t[i] for t in staps]),
               np.stack([t[i] for t in taps]), **F16)
    _close(np.stack([t[5] for t in staps]), np.stack([t[5] for t in taps]),
           rtol=1e-2, atol_rel=1e-3)              # NP


def _cli_lines(out):
    """The CLI's event lines and status rows; the status header's
    searcher cycle time is a wall-clock time and is left out."""
    return [ln for ln in out.splitlines()
            if ln.startswith("[") or ln[:3].strip().isdigit()]


def test_tracker_cli_host_path_matches_jax(capsys):
    """``--no-batch --backend numpy`` (the host data plane and the host
    searcher: nothing on a device) prints what the JAX CLI prints by
    default: the same events and status rows."""
    base = ["-f", "739e6", "--simulate", "-p", "10", "--blocks", "100"]
    assert cli.main(base + ["--no-batch", "--backend", "numpy",
                            "--device", "cpu"]) == 0
    got = _cli_lines(capsys.readouterr().out)
    assert jax_tracker_cli.main(base) == 0
    want = _cli_lines(capsys.readouterr().out)
    assert got == want
    assert any(ln.startswith("[cell_acquired] {'n_id_cell': 271")
               for ln in got)
    assert any(ln.split()[:1] == ["271"] and "100.0%" in ln for ln in got)
