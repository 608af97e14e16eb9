"""The tracer's spans on the port's measured paths (utils/profiling.py):
cell_search, the whole-stack and pipelined sweeps and the tracker, each
on tiny simulator inputs on the CPU (device="cpu": the kernels' plain
versions), with the process's tracer on."""

import numpy as np
import pytest

from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.parallel.fc_sweep import sharded_search_sweep
from lte_cell_scanner_tpu_torch.search.cell_search import cell_search
from lte_cell_scanner_tpu_torch.search.pipeline import pipelined_search_sweep
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER
from torch_one_thread import _one_torch_thread  # noqa: F401

FSET = np.arange(-2, 3) * 5e3
FCS = [739.0e6, 739.1e6]


@pytest.fixture
def tracer():
    """The process's tracer, on and cleared for the test, then off."""
    TRACER.reset()
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


@pytest.fixture(scope="module")
def caps():
    return np.stack([
        synthetic_capture(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10,
                          freq_offset=7.7e3, n_rb_dl=50, seed=3),
        synthetic_capture(n_id_1=30, n_id_2=0, snr_db=15, freq_offset=6e3,
                          n_rb_dl=75, seed=7),
    ])


def _layer_adds_up(spans, layer, before=()):
    """The layer's span holds its stages, but those in ``before``, opened
    ahead of it: its seconds are its self time plus its stages' seconds
    (the waits sit inside the stages)."""
    top = spans[layer]
    stages = sum(v["seconds"] for k, v in spans.items()
                 if k.startswith(layer + ".") and k != layer + ".wait"
                 and k not in before)
    assert top["seconds"] == pytest.approx(top["self_s"] + stages,
                                           rel=1e-9)


def test_cell_search_spans(tracer, caps):
    cells = cell_search(caps[0], FCS[0], f_search_set=FSET, device="cpu")
    assert [c.n_id_cell() for c in cells] == [271]
    snap = tracer.snapshot()
    spans, counts = snap["spans"], snap["counts"]
    stages = {"search.upload", "search.scan", "search.peaks", "search.sync",
              "search.mib"}
    assert {"search", "search.wait"} | stages <= set(spans)
    assert all(spans[k]["calls"] == 1 for k in stages | {"search"})
    assert counts["search.waits"] == spans["search.wait"]["calls"] >= 1
    _layer_adds_up(spans, "search")


def test_host_backend_opens_no_span(tracer, caps):
    cell_search(caps[0], FCS[0], backend="numpy")
    assert tracer.snapshot()["spans"] == {}


def test_sweep_spans(tracer, caps):
    planes = np.stack([iq_to_bytes(0.3 * c).reshape(-1, 2).T for c in caps])
    per_cap, cells = sharded_search_sweep(planes, FCS, FSET, device="cpu")
    assert sorted(c.n_id_cell() for c in cells) == [90, 271]
    spans = tracer.snapshot()["spans"]
    stages = {"sweep.stack", "sweep.plan", "sweep.scan", "sweep.tables",
              "sweep.sync", "sweep.mib", "sweep.dedup"}
    assert stages | {"sweep", "sweep.wait"} <= set(spans)
    assert all(spans[k]["calls"] == 1 for k in stages | {"sweep"})
    assert not any(k.startswith("search") for k in spans)
    _layer_adds_up(spans, "sweep", before={"sweep.stack"})


def test_pipeline_spans(tracer, caps):
    planes = np.stack([iq_to_bytes(0.3 * c).reshape(-1, 2).T for c in caps])
    pipelined_search_sweep(planes, FCS, FSET, device="cpu", batch=1)
    spans = tracer.snapshot()["spans"]
    stages = {"pipe.upload", "pipe.scan", "pipe.tables", "pipe.sync_dispatch",
              "pipe.sync_collect", "pipe.mib_dispatch", "pipe.mib_collect"}
    assert stages | {"pipe", "pipe.wait"} <= set(spans)
    assert all(spans[k]["calls"] == 2 for k in stages)
    _layer_adds_up(spans, "pipe")


def test_tracker_spans(tracer):
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15, freq_offset=4e3,
                            n_subframes=100, sfn_start=0, seed=5)
    trk = LTETracker(739e6, initial_freq_offset=4000.0, device="cpu")
    trk.run(playback_source(sig), max_blocks=60)
    assert [c.n_id_cell for c in trk.cells] == [271]
    snap = tracer.snapshot()
    spans, counts = snap["spans"], snap["counts"]
    assert spans["tracker.step"]["calls"] == spans["tracker.feed"]["calls"] \
        == 60
    assert spans["engine"]["calls"] == 60
    assert spans["tracker.searcher"]["calls"] \
        == trk.status()["searcher_passes"] >= 1
    stages = {"engine.demod", "engine.route", "engine.stats",
              "engine.finalize", "engine.wait"}
    assert stages <= set(spans)
    assert counts["engine.waits"] == spans["engine.wait"]["calls"] >= 2
    _layer_adds_up(spans, "engine")
    # The engine's stages and waits hold all but its own bookkeeping.
    engine = spans["engine"]
    assert engine["self_s"] < 0.5 * engine["seconds"]
