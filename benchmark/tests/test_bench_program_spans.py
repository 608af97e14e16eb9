"""The per-layer metrics read from the program's own tracer
(``benchmark/program.py``): tiny runs on the CPU."""

import json

import pytest

from benchmark import harness
from benchmark.manifest import ROOT, load_cell
from benchmark.tests.tiny import SEED, overrides

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
           if m["source"] == "program_counter"}
# Each traced cell's spans over its traced part: the layer's top span and
# its stages.
LAYERS = {"band17.sweep": ("sweep", ["sweep.stack", "sweep.plan",
                                     "sweep.scan", "sweep.tables",
                                     "sweep.sync", "sweep.mib",
                                     "sweep.dedup"]),
          "band17.serial": ("search", ["search.upload", "search.scan",
                                       "search.peaks", "search.sync",
                                       "search.mib"]),
          "tracker739.site1": ("tracker.step", ["tracker.feed", "engine",
                                                "engine.demod",
                                                "engine.route",
                                                "engine.stats",
                                                "engine.finalize"])}


@pytest.fixture
def tracer():
    from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

    TRACER.disable()
    TRACER.reset()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


@pytest.fixture
def traced_part(monkeypatch, tracer):
    """The tracer on over a traced run's traced part alone, where the
    profiler turns it on on the card (no profiler runs on the CPU): each
    entry's step turns it on once the harness has closed its own spans."""
    make_entry = harness.make_entry

    def make(*args, **kwargs):
        entry = make_entry(*args, **kwargs)
        step = entry.step

        def traced_step():
            if not entry.spans.on and not tracer.on:
                tracer.reset()
                tracer.enable()
            return step()

        entry.step = traced_step
        return entry

    monkeypatch.setattr(harness, "make_entry", make)
    return tracer


def test_every_program_metric_is_read_in_a_cell():
    assert set(PROGRAM) == {"search.waits_per_search",
                            "tracker.engine_waits_per_block"}
    for name, cells in PROGRAM.items():
        assert [m["name"] for m in load_cell(cells[0]).per_layer
                if m["name"] == name] == [name]


@pytest.mark.parametrize("cell", ["band17.sweep", "band17.serial",
                                  "tracker739.site1"])
def test_tiny_traced_run_reports_the_program_metrics(cell, traced_part):
    run = harness.run_cell(cell, SEED, 1.0, True, device="cpu",
                           overrides=overrides(cell))
    assert run.correct, run.checks
    top, stages = LAYERS[cell]
    spans = traced_part.snapshot()["spans"]
    assert {top, *stages} <= set(spans)
    for name in [n for n, cells in PROGRAM.items() if cell in cells]:
        value = run.metrics[name]["value"]
        assert isinstance(value, float) and value > 0.0, (name, value)


def test_a_reader_refuses_what_the_tracer_recorded_outside_the_part(
        traced_part):
    """The tracer on from before the window: the layer's top span counts
    more calls than the profiled part did, and the reader raises."""
    traced_part.enable()
    with pytest.raises(RuntimeError, match="outside that part"):
        harness.run_cell("band17.serial", SEED, 1.0, True, device="cpu",
                         overrides=overrides("band17.serial"))


def test_untraced_run_leaves_the_tracer_off(tracer):
    run = harness.run_cell("band17.serial", SEED, 1.0, False, device="cpu",
                           overrides=overrides("band17.serial"))
    assert run.correct and not tracer.on
    assert tracer.snapshot()["spans"] == {}
    assert not set(PROGRAM) & set(run.metrics)


def test_traced_run_without_the_profiler_reads_nothing(tracer):
    """On the CPU no profiler runs, so the tracer records nothing and the
    readers return None, as they do for a program without the tracer."""
    run = harness.run_cell("band17.serial", SEED, 1.0, True, device="cpu",
                           overrides=overrides("band17.serial"))
    assert run.correct
    assert tracer.snapshot()["spans"] == {}
    assert not set(PROGRAM) & set(run.metrics)
