"""The dongle's clock (``sim/dongle.py``) and the four-cell tracker cell
``tracker739rtl.site4``: the generator against its plain reference, a
tiny traced run on the CPU that reports the cell's per-layer metrics
(all but the device trace's, which the CPU has not), and the control: the
same mix on ``sim/site.py``'s clock, which moves the LO alone, fails
``mib_miss_share``."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.manifest import HERE, ROOT, load_cell
from benchmark.reference import dongle as plain
from benchmark.sim import dongle
from benchmark.tests.test_bench_program_spans import (  # noqa: F401
    traced_part, tracer)
from benchmark.tests.tiny import SEED

CELL = "tracker739rtl.site4"
SPEC = json.loads((HERE / "traffic" / "site4.json").read_text())["site"]
LIMITS = json.loads((HERE / "configs" / "tracker739rtl.json")
                    .read_text())["check"]
# The tiny size: chunks of 40 blocks; kalibrate keeps ppm 120, since
# the dongle's offset (46.2 kHz) lies outside a narrower search.
TINY = {"config": {"blocks_per_status": 40}, "traffic": {}}


def test_the_copies_are_equal():
    assert (HERE / "reference" / "dongle.py").read_bytes() \
        == (ROOT / "tests" / "plain_dongle.py").read_bytes()


@pytest.mark.parametrize("slip", [12, -12])
def test_generator_matches_the_reference(slip):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(120) + 1j * rng.standard_normal(120)
    fc = 385 * 1.92e6
    got, _ = dongle.dongle_clock(x, slip, fc)
    want = plain.dongle_samples(x, slip, fc, 1.92e6, np.arange(120 + slip))
    assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))


def test_site_is_the_dongles():
    base = dongle.site_gen.draw_site(dict(SPEC, max_freq_offset_hz=0.0), 11)
    site = dongle.draw_site(SPEC, 11)
    m = dongle.crystal_slip(SPEC, 11)
    n = SPEC["recording_ms"] * 1920
    delta = m / n
    assert abs(m) == SPEC["slip"] and abs(delta) == 62.5e-6
    assert site.freq_offset == -delta * SPEC["fc"]
    assert len(site.recording) == n + m
    assert [c.pci for c in site.cells] == [c.pci for c in base.cells]
    assert [c.sfn_start for c in site.cells] \
        == [c.sfn_start for c in base.cells]
    assert site.noise_power == base.noise_power
    assert np.array_equal(site.recording, dongle.draw_site(SPEC, 11)
                          .recording)


def test_tiny_traced_run_reports_the_cells_metrics(traced_part):
    run = harness.run_cell(CELL, SEED, 1.0, True, device="cpu",
                           overrides=TINY)
    assert run.correct, run.checks
    new = {m["name"] for m in load_cell(CELL).per_layer
           if m["name"].startswith("tracker4.")}
    # The device trace and the CUDA graphs are the card's alone.
    card = {"tracker4.device_idle", "tracker4.engine_graph_replays_per_block"}
    assert new - set(run.metrics) == card
    for name in new - card - {"tracker4.engine_waits_per_block"}:
        assert run.metrics[name]["value"] > 0.0, name
    assert run.metrics["tracker4.engine_waits_per_block"]["value"] >= 0.0
    assert run.metrics["tracker4.engine_cells_per_block"]["value"] == 4.0
    assert run.answers["tracked"] >= 4


def _offset_only_seed() -> int:
    """A seed whose site, on ``sim/site.py``'s clock, lies 4-5 kHz off:
    the offset is that generator's first draw."""
    step = 1.92e6 / (400 * 1920)
    for seed in range(SEED, SEED + 1000):
        rng = np.random.default_rng([seed, 0x5173])
        if abs(rng.integers(-2000, 2001)) * step >= 4000:
            return seed
    raise AssertionError("no seed")


def test_control_on_the_lo_only_clock_fails():
    """The site4 mix with the frequency offset alone (no sampling-rate
    error, which no dongle has): the weak cells' timing loops cannot
    follow the frame drift the offset implies, and their MIBs stop."""
    seed = _offset_only_seed()
    site = dict(SPEC, max_freq_offset_hz=5000.0)
    run = harness.run_cell(CELL, seed, 6.0, False, device="cpu",
                           overrides={"config": TINY["config"],
                                      "traffic": {"generator": "site",
                                                  "site": site}})
    assert not run.correct
    assert run.checks["mib_miss_share"]["value"] \
        > LIMITS["mib_miss_share"], run.checks


def test_the_reference_searches_kalibrates_first_captures():
    """The entry's captures are those kalibrate's stream gives, one after
    another; the first is the tracker entry's one capture."""
    from benchmark.entries import make_entry
    from benchmark.trace import Spans

    cell = load_cell(CELL)
    entry = make_entry(cell.config, cell.traffic, SEED, "cpu", Spans())
    entry.site = entry.gen.draw_site(cell.traffic["site"], SEED)
    caps = entry.reference_captures(153600, 4)
    assert caps.shape == (4, 153600)
    assert np.array_equal(caps[0], entry.reference_capture(153600))
    whole = entry.reference_capture(4 * 153600)
    assert np.array_equal(caps.reshape(-1), whole)
