"""The port's tools (lte_cell_scanner_tpu_torch/tools/, device="cpu": the
kernels' plain versions) and their support modules vs the JAX package's on
the same inputs: the host tools' results exactly (the same numpy code), the
Monte-Carlo harness' statistics (the same trials: equal detections, MIB
decodes and false cells, frequency errors within 0.5 Hz), and the
benchmarks' result keys and correctness checks at small sizes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.io.simulator import synthetic_capture
from lte_cell_scanner_tpu.tools import mc_search as jax_mc
from lte_cell_scanner_tpu.tools import noise_bias as jax_nb
from lte_cell_scanner_tpu.tools import pss_ambiguity as jax_amb
from lte_cell_scanner_tpu.tools.rtl_sdr_check import \
    check_capture as jax_check_capture
from lte_cell_scanner_tpu_torch.tools import (bench_decode, bench_demod,
                                              bench_scan, bench_viterbi,
                                              bench_wideband, mc_search,
                                              noise_bias, pss_ambiguity)
from lte_cell_scanner_tpu_torch.tools.rtl_sdr_check import check_capture
from torch_one_thread import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sig200():
    # tests/test_tools.py's capture.
    return synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                             freq_offset=0.0, n_subframes=200, seed=2)


@pytest.mark.parametrize("damage", ["clean", "drop37", "insert20"])
def test_check_capture_matches_jax(sig200, damage):
    """tests/test_tools.py's three cases: the same events and lags."""
    sig = {"clean": sig200,
           "drop37": np.concatenate([sig200[:180000], sig200[180037:]]),
           "insert20": np.concatenate([sig200[:150000],
                                       np.zeros(20, dtype=complex),
                                       sig200[150000:]])}[damage]
    events, lags = check_capture(sig, n_id_2=1)
    want_events, want_lags = jax_check_capture(sig, n_id_2=1)
    assert [(e.position, e.jump) for e in events] == \
        [(e.position, e.jump) for e in want_events]
    np.testing.assert_array_equal(lags, want_lags)
    assert (events == []) == (damage == "clean")


def test_noise_bias_matches_jax():
    assert noise_bias.residual_noise_factor() == \
        jax_nb.residual_noise_factor()
    assert noise_bias.smoothed_noise_factor() == \
        jax_nb.smoothed_noise_factor()
    assert noise_bias.monte_carlo_factor(trials=4000, seed=3) == \
        jax_nb.monte_carlo_factor(trials=4000, seed=3)


def test_pss_ambiguity_matches_jax(capsys):
    from lte_cell_scanner_tpu.tracker.display import ascii_plot as jax_plot
    from lte_cell_scanner_tpu_torch.tracker.display import ascii_plot

    f = np.linspace(-30e3, 30e3, 61)
    np.testing.assert_array_equal(pss_ambiguity.freq_ambiguity(f),
                                  jax_amb.freq_ambiguity(f))
    t = np.arange(-8, 9)
    np.testing.assert_array_equal(pss_ambiguity.time_ambiguity(t),
                                  jax_amb.time_ambiguity(t))
    vals = np.sin(np.linspace(0, 7, 90))
    assert ascii_plot(vals, width=64, label="x") == \
        jax_plot(vals, width=64, label="x")
    argv = ["--n-freq", "41", "--t-max", "8"]
    pss_ambiguity.main(argv)
    got = capsys.readouterr().out
    jax_amb.main(argv)
    assert got == capsys.readouterr().out


def test_debug_dump_and_itfile_roundtrip(tmp_path):
    from lte_cell_scanner_tpu.io.itfile import load_it as jax_load_it
    from lte_cell_scanner_tpu.io.itfile import save_it as jax_save_it
    from lte_cell_scanner_tpu_torch.io.itfile import load_it, save_it
    from lte_cell_scanner_tpu_torch.utils import debug_dump

    debug_dump.clear()
    debug_dump.dump("x", np.arange(5.0))
    debug_dump.dump("c", np.array([1 + 2j, 3 - 4j]))
    debug_dump.dump("t", torch.arange(6, dtype=torch.int32).view(2, 3))
    p = str(tmp_path / "dbg.it")
    debug_dump.flush(p)
    for back in (load_it(p), jax_load_it(p)):
        np.testing.assert_array_equal(back["x"], np.arange(5.0))
        np.testing.assert_array_equal(back["c"], np.array([1 + 2j, 3 - 4j]))
        np.testing.assert_array_equal(back["t"], np.arange(6).reshape(2, 3))
    recs = {"m": np.arange(6.0).reshape(2, 3), "b": np.array([1, 0, 1],
                                                             np.uint8)}
    save_it(str(tmp_path / "a.it"), recs)
    jax_save_it(str(tmp_path / "b.it"), recs)
    assert (tmp_path / "a.it").read_bytes() == (tmp_path / "b.it").read_bytes()


def test_load_rtl_sdr(tmp_path):
    from lte_cell_scanner_tpu.io.raw import load_rtl_sdr as jax_load
    from lte_cell_scanner_tpu_torch.io.raw import load_rtl_sdr

    raw = np.random.default_rng(1).integers(0, 256, 4001).astype(np.uint8)
    path = str(tmp_path / "cap.bin")
    raw.tofile(path)
    np.testing.assert_array_equal(load_rtl_sdr(path, drop_seconds=1e-3),
                                  jax_load(path, drop_seconds=1e-3))


def _tracer_off(tracer, monkeypatch):
    """Off, a span is the one shared no-op: it reads no clock, enters no
    profiler range, allocates nothing and aggregates nothing."""
    import sys

    from lte_cell_scanner_tpu_torch.utils import profiling

    def refuse(*a, **k):
        raise AssertionError("the off path called it")

    monkeypatch.setattr(profiling, "perf_counter", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    assert tracer.span("a") is tracer.span("b") is tracer.wait()
    with tracer.span("search"):
        with tracer.wait():
            pass
    blocks = sys.getallocatedblocks()
    for _ in range(10000):
        with tracer.span("search.scan"):
            pass
    assert sys.getallocatedblocks() - blocks < 10
    assert tracer.snapshot()["spans"] == {} and tracer.counts == {}


def _tracer_nesting(tracer, monkeypatch):
    """On, a span adds its duration to its name and to its parent's child
    seconds: self_s = seconds - child seconds."""
    import time

    tracer.enable()
    for _ in range(2):
        with tracer.span("sweep"):
            time.sleep(0.01)
            with tracer.span("sweep.scan"):
                time.sleep(0.02)
    spans = tracer.snapshot()["spans"]
    top, scan = spans["sweep"], spans["sweep.scan"]
    assert top["calls"] == scan["calls"] == 2
    assert scan["seconds"] >= 0.04 and top["seconds"] >= 0.06
    assert top["self_s"] == pytest.approx(top["seconds"] - scan["seconds"],
                                          abs=1e-12)
    assert 0.02 <= top["self_s"] < top["seconds"]
    assert scan["self_s"] == scan["seconds"]
    tracer.disable()
    with tracer.span("sweep"):
        pass
    assert tracer.snapshot()["spans"]["sweep"]["calls"] == 2


def _tracer_wait(tracer, monkeypatch):
    """wait() is named after the innermost open span's layer, which also
    counts its waits; the waits leave their stage's self time."""
    tracer.enable()
    with tracer.span("engine"):
        with tracer.span("engine.demod"):
            with tracer.wait():
                pass
            with tracer.wait():
                pass
        with tracer.wait():
            pass
    with tracer.span("search"):
        with tracer.wait():
            pass
    with tracer.wait():
        pass
    snap = tracer.snapshot()
    spans, counts = snap["spans"], snap["counts"]
    assert spans["engine.wait"]["calls"] == counts["engine.waits"] == 3
    assert spans["search.wait"]["calls"] == counts["search.waits"] == 1
    assert spans["wait"]["calls"] == counts["waits"] == 1
    demod = spans["engine.demod"]
    assert demod["self_s"] < demod["seconds"]


def _tracer_counts(tracer, monkeypatch):
    """Counters count on or off, from the last reset; a wait counts only
    while the tracer is on, when its layer is known."""
    tracer.count("search.waits", 3)
    with tracer.span("search"):
        with tracer.wait():
            pass
    assert tracer.snapshot()["counts"] == {"search.waits": 3}
    tracer.reset()
    tracer.count("search.waits")
    tracer.enable()
    with tracer.span("search"):
        with tracer.wait():
            pass
    assert tracer.snapshot()["counts"] == {"search.waits": 2}


def _tracer_traced(tracer, monkeypatch):
    """A function under traced(name) is a span name a call, its name and
    result kept, and does nothing more off."""
    @tracer.traced("engine")
    def process_all(cells, step=1):
        """Doc."""
        with tracer.span("engine.route"):
            return len(cells) * step

    assert process_all.__name__ == "process_all"
    assert process_all.__doc__ == "Doc."
    assert process_all([1, 2], step=3) == 6
    assert tracer.snapshot()["spans"] == {}
    tracer.enable()
    assert process_all([1]) == 1
    spans = tracer.snapshot()["spans"]
    assert spans["engine"]["calls"] == spans["engine.route"]["calls"] == 1
    assert spans["engine"]["self_s"] < spans["engine"]["seconds"]


def _tracer_profiler(tracer, monkeypatch):
    """While the profiler records, the tracer records too (enabled or
    not) and each span is an lte.* range, nested as the spans were."""
    with torch.profiler.profile() as prof:
        with tracer.span("sweep"):
            with tracer.span("sweep.plan"):
                torch.ones(64).cumsum(0)
            with tracer.wait():
                pass
    ranges = {e.name: e for e in prof.events() if e.name.startswith("lte.")}
    assert set(ranges) == {"lte.sweep", "lte.sweep.plan", "lte.sweep.wait"}
    outer = ranges["lte.sweep"].time_range
    for name in ("lte.sweep.plan", "lte.sweep.wait"):
        inner = ranges[name].time_range
        assert outer.start <= inner.start and inner.end <= outer.end
    assert tracer.snapshot()["spans"]["sweep.plan"]["calls"] == 1
    assert tracer.span("sweep") is tracer.wait()     # off again


@pytest.mark.parametrize("case", [_tracer_off, _tracer_nesting,
                                  _tracer_wait, _tracer_counts,
                                  _tracer_traced, _tracer_profiler],
                         ids=lambda f: f.__name__[len("_tracer_"):])
def test_stage_timer_and_trace(case, monkeypatch):
    """The program's tracer (utils/profiling.py), each case on a fresh
    StageTimer."""
    from lte_cell_scanner_tpu_torch.utils.profiling import StageTimer

    case(StageTimer(), monkeypatch)


def test_mc_search_matches_jax():
    """The same seed draws the same trials in both harnesses."""
    got = mc_search.run_mc(trials=2, snr_db=15.0, seed=7, ppm=5.0,
                           device="cpu", verbose=0)
    want = jax_mc.run_mc(trials=2, snr_db=15.0, backend="numpy", seed=7,
                         ppm=5.0, verbose=0)
    assert got.trials == want.trials == 2
    assert got.detections == want.detections == 2
    assert got.mib_successes == want.mib_successes == 2
    assert got.false_cells == want.false_cells == 0
    np.testing.assert_allclose(got.freq_errs, want.freq_errs, atol=0.5)
    assert mc_search.wilson_lower(49, 50) == jax_mc.wilson_lower(49, 50)


def test_mc_search_numpy_backend_matches_jax():
    """backend="numpy" runs the port's float64 host chain: the same trials
    give the JAX harness's statistics field by field, exactly (the chains
    are bit-equal copies); the CLI takes --backend numpy and reports it."""
    got = mc_search.run_mc(trials=2, snr_db=15.0, backend="numpy", seed=7,
                           ppm=5.0, verbose=0)
    want = jax_mc.run_mc(trials=2, snr_db=15.0, backend="numpy", seed=7,
                         ppm=5.0, verbose=0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.detections == got.mib_successes == 2
    out = mc_search.main(["--backend", "numpy", "--trials", "0"])
    assert out["backend"] == "numpy" and out["trials"] == 0
    with pytest.raises(SystemExit):
        mc_search.main(["--backend", "jax"])


@pytest.fixture(scope="module")
def scans():
    return {layout: bench_scan.main(["--device", "cpu", "--ppm", "10",
                                     "--iters", "2", "--layout", layout])
            for layout in ("tea", "roll", "tea3")}


@pytest.mark.parametrize("layout", ["tea", "roll", "tea3"])
def test_bench_scan_layouts(scans, layout):
    out = scans[layout]
    for key in ("correlate_fold_ms", "full_scan_ms", "metric", "value",
                "unit", "precision", "layout", "tile", "n_f",
                "matmul_gflop", "samples_per_sec"):
        assert key in out
    assert out["layout"] == layout and out["n_f"] == 3
    assert out["tile"] == 160
    # The function's tensor-core work: 3xTF32 products of 8 (2x2) or 6
    # (Karatsuba) real flops per complex tap, over the TF32 peak.
    assert out["tc_gflop"] == pytest.approx(
        9 * 9600 * out["n_comb_xc"] * 137 * (6 if layout == "tea3" else 8)
        * 3 / 1e9, abs=0.006)
    assert out["tc_peak_tflops"] == 495.0 and out["tc_share"] is None
    assert out["device"] == "cpu"
    # Real products per tap: four in the 2x2 layouts, three in tea3.
    assert out["matmul_gflop"] == pytest.approx(
        scans["tea"]["matmul_gflop"] * (0.75 if layout == "tea3" else 1),
        abs=0.06)
    # The same peaks (lag, hypothesis, root) whatever the layout; their
    # powers within the fold's f32 tolerance.
    got, want = np.array(out["peaks"]), np.array(scans["tea"]["peaks"])
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)


def test_bench_viterbi_bits():
    out = bench_viterbi.main(["--device", "cpu", "--batch", "64",
                              "--iters", "1"])
    assert out["batch"] == 64 and out["backend"] == "cpu"
    assert out["plain_bits_equal"] and out["cuda_bits_equal"]
    assert out["plain_ms"] > 0 and out["cuda_ms"] > 0


def test_bench_decode_stages():
    out = bench_decode.main(["--device", "cpu", "--batch", "4",
                             "--iters", "1"])
    assert out["b_candidates"] == 4 and out["mib_decoded"] == 4
    assert out["synced_decoded"] == out["n_synced"] and out["replicas_agree"]
    assert out["cells"] == [271]
    cum = [out[f"mib_{st}_ms"] for st in bench_decode.STAGES]
    assert cum == sorted(cum) and out["value"] == cum[-1]
    assert sum(out[f"mib_{st}_delta_ms"] for st in bench_decode.STAGES) \
        == pytest.approx(cum[-1])


def test_bench_decode_stage_subset():
    """--stages reports the named milestones only, in pipeline order, each
    delta from the previous reported one; "full" is timed whatever."""
    out = bench_decode.main(["--device", "cpu", "--batch", "2",
                             "--iters", "1", "--stages", "vit,tfg,nope"])
    assert not any(f"mib_{st}_ms" in out
                   for st in ("tfoec", "toe", "chanest", "pbch", "llr",
                              "full"))
    assert out["mib_tfg_delta_ms"] == out["mib_tfg_ms"]
    assert out["mib_vit_delta_ms"] == out["mib_vit_ms"] - out["mib_tfg_ms"]
    assert out["value"] >= out["mib_vit_ms"] >= out["mib_tfg_ms"] > 0


def test_bench_demod_sizes():
    out = bench_demod.main(["--device", "cpu", "--windows", "5,40",
                            "--samples", "4000", "--iters", "1"])
    assert out["device"] == "cpu" and out["samples"] == 4000
    assert [r["windows"] for r in out["sizes"]] == [5, 40]
    for r in out["sizes"]:
        # On the CPU both variants run the plain version.
        assert r["max_abs_err"] == 0.0
        assert r["plain_ms"] > 0 and r["cuda_ms"] > 0


def test_bench_wideband_keys():
    """The JAX tool's JSON keys, both forms timed (the host clock on the
    CPU) at 4 carriers."""
    out = bench_wideband.main(["--device", "cpu", "--carriers", "4",
                               "--decim", "4", "--iters", "1"])
    assert out["metric"] == "wideband_channelize_ms_per_carrier"
    assert out["carriers"] == 4 and out["decim"] == 4
    assert out["n_out"] == 153600 and out["device"] == "cpu"
    assert out["value"] == pytest.approx(out["bank_ms"] / 4)
    assert out["carriers_per_sec"] == pytest.approx(4e3 / out["bank_ms"])
    assert out["map_ms"] > 0 and out["speedup_vs_map"] == pytest.approx(
        out["map_ms"] / out["bank_ms"])
