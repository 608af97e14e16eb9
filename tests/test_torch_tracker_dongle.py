"""The four-cell site as an RTL-SDR dongle records it, and the port's
tracker on it.

The benchmark's dongle generator (``benchmark/sim/dongle.py``: one
crystal error on the LO and the sample clock, the recording resampled by
FFT and rotated) against its plain form (``tests/plain_dongle.py``, the
trigonometric series evaluated sample by sample); then the port's batch
engine on the CPU tracking band17's four cells from that recording (the
mix ``site4``) for 200 blocks after kalibrate: every cell held, with the
float64 reference search's MIB, in at least 60% of the PBCH periods; and
the engine's counters ``engine.cell_cycles`` and ``engine.mib_decodes``
over the run's second half against what the engine did there.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import plain_dongle
from benchmark.sim import dongle
from torch_one_thread import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# The mix's site on a 400 ms loop (the mix loops 2 s), which draws in a
# fifth of the time.
SITE4 = dict(json.loads((ROOT / "benchmark" / "traffic" / "site4.json")
                        .read_text())["site"], recording_ms=400, slip=48)
FS = 1.92e6
FC_WHOLE = 385 * FS         # any slip makes whole cycles
SEED = 3000000019
BLOCKS = 100                # a chunk; the run is two
MIB_PERIOD_BLOCKS = 0.04 * FS / 10000
MIB_FIELDS = ("n_ports", "cp_type", "n_rb_dl", "phich_duration",
              "phich_resource")


def _band_limited(n: int, seed: int) -> np.ndarray:
    """A random periodic signal of n samples with no energy in the top
    third of its band."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(n, 1.0 / n)
    spec = np.where(np.abs(k) < n // 3,
                    rng.standard_normal(n) + 1j * rng.standard_normal(n), 0)
    return np.fft.ifft(spec)


@pytest.mark.parametrize("n", [96, 97])
@pytest.mark.parametrize("slip", [12, -12])
def test_generator_matches_plain(n, slip):
    x = _band_limited(n, n + slip)
    got, foff = dongle.dongle_clock(x, slip, FC_WHOLE)
    want = plain_dongle.dongle_samples(x, slip, FC_WHOLE, FS,
                                       np.arange(n + slip))
    assert got.shape == (n + slip,)
    assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))
    assert foff == -slip / n * FC_WHOLE


@pytest.mark.parametrize("slip", [12, -12])
def test_the_loop_continues_across_its_seam(slip):
    """Samples n' - 1, n', n' + 1 of the series (the loop's last, then the
    next loop's first two) are the recording's last, first and second."""
    n = 96
    x = _band_limited(n, 7)
    got, _ = dongle.dongle_clock(x, slip, FC_WHOLE)
    n_new = n + slip
    want = plain_dongle.dongle_samples(x, slip, FC_WHOLE, FS,
                                       np.array([n_new - 1, n_new,
                                                 n_new + 1]))
    scale = np.max(np.abs(got))
    np.testing.assert_allclose(got[[-1, 0, 1]], want, rtol=0,
                               atol=1e-9 * scale)


def test_the_offset_makes_whole_cycles():
    assert dongle.whole_cycles(48, 739e6) == 18475
    assert dongle.whole_cycles(-48, 739e6) == -18475
    with pytest.raises(ValueError, match="not whole"):
        dongle.whole_cycles(12, 739e6)
    # The rotation alone (a constant recording): back to 1 after the loop.
    y, foff = dongle.dongle_clock(np.ones(960), 48, 739e6)
    cycles = foff * len(y) / (FS * (1 + 48 / 960))
    assert cycles == pytest.approx(-18475, abs=1e-6)
    np.testing.assert_allclose(y[0], 1.0, atol=1e-12)
    step = np.angle(y[1:] / y[:-1])
    np.testing.assert_allclose(step, step[0], atol=1e-9)
    assert {dongle.crystal_slip(SITE4, s) for s in range(8)} == {48, -48}


@pytest.fixture(scope="module")
def tracked():
    """The site4 site of SEED, kalibrated at ppm 120 on one stream, then
    two chunks of blocks from another; the tracer on over the second."""
    from benchmark.sim.playback import playback
    from lte_cell_scanner_tpu_torch.tracker.runtime import LTETracker
    from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

    site = dongle.draw_site(SITE4, SEED)
    trk = LTETracker(739e6, engine_every=1, feeder="python", device="cpu")
    trk.kalibrate(playback(site.recording, site.noise_power, [SEED, 1]),
                  ppm=120, correction=1.0)
    src = playback(site.recording, site.noise_power, [SEED, 2])
    assert trk.run(src, max_blocks=BLOCKS) == BLOCKS

    served = []
    process_all = trk.engine.process_all

    def counted(cells):
        served.append(sum(1 for c in cells if c.fifo and not c.kill_me))
        return process_all(cells)

    trk.engine.process_all = counted
    cells = list(trk.cells)
    before = {id(c): c.mib_decode_successes for c in cells}
    TRACER.disable()
    TRACER.reset()
    TRACER.enable()
    try:
        assert trk.run(src, max_blocks=BLOCKS) == BLOCKS
        snap = TRACER.snapshot()
    finally:
        TRACER.disable()
        TRACER.reset()
    cells += [c for c in trk.cells if id(c) not in before]
    decoded = sum(c.mib_decode_successes - before.get(id(c), 0)
                  for c in cells)
    return site, trk, snap, served, decoded


def test_engine_holds_every_cell_with_the_reference_mib(tracked):
    from benchmark.reference.search import cell_search
    from benchmark.sim.playback import BLOCK_SIZE, playback
    from benchmark.sim.raw import bytes_to_iq

    site, trk, _, _, _ = tracked
    src = playback(site.recording, site.noise_power, [SEED, 1])
    cap = bytes_to_iq(np.concatenate([next(src) for _ in range(16)]))
    assert 16 * BLOCK_SIZE >= 153600
    # The grid point of the ppm-120 search nearest the dongle's offset.
    ref = cell_search(cap[:153600], 739e6,
                      [5000.0 * round(site.freq_offset / 5000.0)])
    want = {c.n_id_cell(): c for c in ref}
    assert sorted(want) == sorted(c["pci"] for c in SITE4["cells"])
    held = {c.n_id_cell: c for c in trk.cells if not c.kill_me}
    assert sorted(held) == sorted(want)
    periods = 2 * BLOCKS / MIB_PERIOD_BLOCKS
    for pci, c in held.items():
        assert all(getattr(c, f) == getattr(want[pci], f)
                   for f in MIB_FIELDS), pci
        assert c.mib_decode_successes >= 0.6 * periods, (
            pci, c.mib_decode_successes, periods)
    assert trk.state.frequency_offset == pytest.approx(site.freq_offset,
                                                       abs=20.0)


def test_engine_counters_count_what_the_engine_did(tracked):
    _, _, snap, served, decoded = tracked
    assert snap["spans"]["engine"]["calls"] == len(served) == BLOCKS
    assert snap["counts"]["engine.cell_cycles"] == sum(served) \
        == 4 * BLOCKS
    assert snap["counts"]["engine.mib_decodes"] == decoded > 0
