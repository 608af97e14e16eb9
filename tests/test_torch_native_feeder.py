"""The port's native (C++) sample feeder (tracker/native_feeder.py over
the repo's native/feeder.cpp, built into build/native/) against the JAX
package's Python feeder in descriptor mode and the port's own, and the
port's tracker with feeder="native" on the CPU.

Tolerances: descriptor counts, stream starts, slots and symbols exact;
``late`` within 1e-6 samples and the searcher capture within 1e-6 (the
C++ clock and the float32 capture round differently from the float64
Python feeder; tests/test_native_feeder.py allows the same); the tracker
runs with the same cells and MIB decodes.
"""

import hashlib
import shutil

import numpy as np
import pytest

from lte_cell_scanner_tpu.tracker.producer import \
    SampleFeeder as JaxSampleFeeder
from lte_cell_scanner_tpu.tracker.state import GlobalState as JaxState
from lte_cell_scanner_tpu.tracker.state import TrackedCell as JaxCell
from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq, iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.tracker import native_feeder
from lte_cell_scanner_tpu_torch.tracker.native_feeder import (
    NativeSampleFeeder)
from lte_cell_scanner_tpu_torch.tracker.producer import SampleFeeder
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell
from torch_one_thread import _one_torch_thread  # noqa: F401

COMMITTED = native_feeder.ROOT / "native" / "libfeeder.so"


@pytest.fixture(autouse=True, scope="module")
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++) to build native/feeder.cpp")


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _cell_kw(n_id=271, frame_timing=1234.5):
    return dict(n_id_cell=n_id, n_ports=1, cp_type="normal", n_rb_dl=50,
                phich_duration="normal", phich_resource=1.0,
                frame_timing=frame_timing)


def _noise_bytes(seed, n):
    rng = np.random.default_rng(seed)
    return iq_to_bytes((rng.standard_normal(n)
                        + 1j * rng.standard_normal(n)) * 0.2)


def test_descriptor_mode_matches_jax_python_feeder():
    """tests/test_native_feeder.py::test_native_descriptor_mode_matches_
    python's scenario: the same bytes through the port's C++ feeder and
    the JAX package's Python feeder with emit_descriptors=True."""
    raw = _noise_bytes(3, 150000)
    sig_q = bytes_to_iq(raw)
    py = JaxSampleFeeder(JaxState(739e6, 739e6, 1.92e6, 4000.0),
                         searcher_capbuf_len=19200 * 2,
                         emit_descriptors=True)
    na = NativeSampleFeeder(GlobalState(739e6, 739e6, 1.92e6, 4000.0),
                            searcher_capbuf_len=19200 * 2)
    cell_py, cell_na = JaxCell(**_cell_kw()), TrackedCell(**_cell_kw())
    for k in range(0, len(sig_q), 10000):
        py.feed(sig_q[k:k + 10000], [cell_py])
        na.feed_bytes(raw[2 * k:2 * (k + 10000)], [cell_na])
    assert len(cell_py.fifo) == len(cell_na.fifo) > 50
    for a, b in zip(cell_py.fifo, cell_na.fifo):
        assert (a.start, a.slot_num, a.sym_num) == (b.start, b.slot_num,
                                                    b.sym_num)
        assert abs(a.late - b.late) < 1e-6
        assert (a.frequency_offset, a.frame_timing) == \
            (b.frequency_offset, b.frame_timing)


def test_searcher_capture_matches_python_feeder():
    """tests/test_native_feeder.py::test_native_matches_python's
    scenario against the port's Python feeder: the searcher capture, its
    lateness, the clock and the descriptors of a tracked cell; the
    compatibility shim feed() gives the same as feed_bytes()."""
    raw = _noise_bytes(0, 200000)
    sig_q = bytes_to_iq(raw)
    feeders = [SampleFeeder(GlobalState(739e6, 739e6, 1.92e6, 4000.0),
                            searcher_capbuf_len=19200 * 2)]
    feeders += [NativeSampleFeeder(GlobalState(739e6, 739e6, 1.92e6,
                                               4000.0),
                                   searcher_capbuf_len=19200 * 2)
                for _ in range(2)]
    cells = [TrackedCell(**_cell_kw()) for _ in feeders]
    for f in feeders:
        f.request_searcher_capture()
    for k in range(0, 200000, 10000):
        feeders[0].feed(sig_q[k:k + 10000], [cells[0]])
        feeders[1].feed_bytes(raw[2 * k:2 * (k + 10000)], [cells[1]])
        feeders[2].feed(sig_q[k:k + 10000], [cells[2]])
    caps = [f.take_searcher_capture() for f in feeders]
    assert all(c is not None and len(c) == 19200 * 2 for c in caps)
    for f, c, cell in zip(feeders[1:], caps[1:], cells[1:]):
        np.testing.assert_allclose(c, caps[0], rtol=0, atol=1e-6)
        assert abs(f.searcher_late - feeders[0].searcher_late) < 1e-9
        assert abs(f.sample_time - feeders[0].sample_time) < 1e-6
        assert [(p.start, p.slot_num, p.sym_num) for p in cell.fifo] == \
            [(p.start, p.slot_num, p.sym_num) for p in cells[0].fifo]


def test_cells_keyed_by_id():
    """Cells with distinct IDs each get their own windows; a dropped
    cell's state machine is removed."""
    raw = _noise_bytes(5, 60000)
    st = GlobalState(739e6, 739e6, 1.92e6, 0.0)
    na = NativeSampleFeeder(st)
    py = SampleFeeder(GlobalState(739e6, 739e6, 1.92e6, 0.0))
    kws = [_cell_kw(n_id, ft) for n_id, ft in ((1, 100.25), (7, 9000.5),
                                                (503, 18000.0))]
    c_na = [TrackedCell(**kw) for kw in kws]
    c_py = [TrackedCell(**kw) for kw in kws]
    sig_q = bytes_to_iq(raw)
    for k in range(0, 60000, 10000):
        if k == 30000:
            c_na[1].kill_me = c_py[1].kill_me = True
        na.feed_bytes(raw[2 * k:2 * (k + 10000)], c_na)
        py.feed(sig_q[k:k + 10000], c_py)
    assert sorted(na._known) == [1, 503]
    for a, b in zip(c_na, c_py):
        assert len(a.fifo) == len(b.fifo) > 0
        assert [p.start for p in a.fifo] == [p.start for p in b.fifo]


def test_tracker_native_matches_python_feeder():
    """The port's tracker on the CPU tracks cell 271 with the same MIB
    decodes whichever feeder cuts its windows."""
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15, freq_offset=4e3,
                            n_subframes=300, sfn_start=0, seed=5)
    status = []
    for feeder in ("python", "native"):
        trk = LTETracker(739e6, initial_freq_offset=4000.0, feeder=feeder,
                         device="cpu")
        trk.run(playback_source(sig), max_blocks=150)
        status.append(trk.status())
    py, na = status
    assert [c["n_id_cell"] for c in na["cells"]] == [271]
    for key in ("n_id_cell", "mib_successes", "health"):
        assert na["cells"][0][key] == py["cells"][0][key], key
    assert na["cells"][0]["mib_successes"] > 5
    assert abs(na["frequency_offset"] - py["frequency_offset"]) < 1e-3


def test_build_leaves_native_dir_untouched(tmp_path, monkeypatch):
    """The library is built under build/native/ (here a temporary
    directory), never into native/: the committed library and the
    directory's listing are unchanged."""
    before = (_digest(COMMITTED), sorted(p.name for p in
                                         COMMITTED.parent.iterdir()))
    monkeypatch.setattr(native_feeder, "LIB_PATH", tmp_path / "libfeeder.so")
    monkeypatch.setattr(native_feeder, "BUILD_DIR", tmp_path)
    assert native_feeder.build_native() == tmp_path / "libfeeder.so"
    assert (tmp_path / "libfeeder.so").stat().st_size > 0
    assert native_feeder.LIB_PATH.parent == tmp_path
    assert (_digest(COMMITTED), sorted(p.name for p in
                                       COMMITTED.parent.iterdir())) == before
    assert native_feeder.SOURCE.parent == COMMITTED.parent


def test_build_native_force(tmp_path, monkeypatch):
    """A library newer than the source is kept; force=True (the JAX
    build_native's option) compiles it again all the same."""
    monkeypatch.setattr(native_feeder, "LIB_PATH", tmp_path / "libfeeder.so")
    monkeypatch.setattr(native_feeder, "BUILD_DIR", tmp_path)
    lib = native_feeder.build_native()
    first = lib.stat().st_ino, lib.stat().st_mtime_ns
    assert native_feeder.build_native() == lib
    assert (lib.stat().st_ino, lib.stat().st_mtime_ns) == first
    assert native_feeder.build_native(force=True) == lib
    assert (lib.stat().st_ino, lib.stat().st_mtime_ns) != first
    assert lib.stat().st_size > 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a build that cannot run raises, naming what failed,
    and so does the tracker that asked for it."""
    monkeypatch.setattr(native_feeder, "_LIB", None)
    monkeypatch.setattr(native_feeder, "LIB_PATH", tmp_path / "libfeeder.so")
    monkeypatch.setattr(native_feeder, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        LTETracker(739e6, feeder="native", device="cpu")
    with pytest.raises(ValueError, match="feeder"):
        LTETracker(739e6, feeder="rust", device="cpu")
