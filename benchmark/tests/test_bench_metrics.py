"""The trace reduction, the per-layer readers and K1's roofline on a
canned profiler table."""

import pytest

from benchmark.manifest import HERE, load_module, reader_path
from benchmark.trace import Window, reduce_events

K1 = "xcorr_fold_tc_kernel(float const*, int, float const*, int)"


def ev(name, start, end, device=True):
    return (name, device, float(start), float(end))


# Device: K1 0-100 us and 50-150 us (overlapping), a copy 400-500 us;
# host: a sweep span over all of it, a sync op inside the gap.
EVENTS = [ev(K1, 0, 100), ev(K1, 50, 150), ev("Memcpy HtoD", 400, 500),
          ev("bench.sweep", 0, 1000, False), ev("aten::copy_", 0, 120, False),
          ev("cudaStreamSynchronize", 150, 400, False)]


def reader(name):
    return load_module(reader_path(name)).read


@pytest.fixture
def trace():
    return reduce_events(EVENTS, window_s=1e-3)


def test_reduction(trace):
    assert trace.n_device_ops == 3
    assert trace.busy_s == pytest.approx(250e-6)
    assert trace.kernels[K1] == (2, pytest.approx(200e-6))
    assert trace.device_ops[0] == [K1, pytest.approx(200e-6)]
    assert trace.idle_gaps == [["cudaStreamSynchronize",
                                pytest.approx(250e-6)]]


def test_device_readers(trace):
    win = Window(units={}, traced_units={"carriers": 2}, spans={},
                 trace=trace, shapes={})
    assert reader("sweep.device_ops_per_carrier")(win) == 1.5
    assert reader("search.device_ops_per_carrier")(win) == 1.5
    for name in ("sweep.device_idle", "search.device_idle",
                 "tracker.device_idle"):
        assert reader(name)(win) == pytest.approx(75.0)


def test_k1_roofline(trace):
    k1 = load_module(HERE / "rooflines" / "xcorr_fold.py")
    shapes = {"n_carriers": 121, "n_hyp": 37, "n_comb": 15, "n_cap": 153600}
    flops = 3 * 3 * 37 * 9600 * 15 * 137 * 8 * 121
    nbytes = 4 * 121 * (2 * 153600 + 3 * 9600 * 37)
    assert k1.flops(121, 37, 15) == flops
    assert k1.nbytes(121, 37, 153600) == nbytes
    bound = max(flops / 495e12, nbytes / 3.35e12)
    win = Window(units={}, traced_units={}, spans={}, trace=trace,
                 shapes=shapes)
    assert reader("sweep.k1_roofline")(win) == pytest.approx(
        100 * 2 * bound / 200e-6)


def test_span_readers():
    win = Window(units={"signal_s": 2.0}, traced_units={},
                 spans={"engine": 0.5, "feeder": 0.25, "searcher": 0.1},
                 trace=None, shapes={})
    assert reader("tracker.engine_ms_per_s")(win) == 250.0
    assert reader("tracker.feeder_ms_per_s")(win) == 125.0
    assert reader("tracker.searcher_ms_per_s")(win) == pytest.approx(50.0)


def test_readers_find_nothing_to_read():
    empty = Window(units={}, traced_units={}, spans={}, trace=None,
                   shapes={})
    for path in (HERE / "metrics").glob("*.py"):
        assert load_module(path).read(empty) is None, path.name
