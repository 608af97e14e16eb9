"""The traffic generators are deterministic in the seed, and every seed
gives the same amount of work."""

import itertools
import json

import numpy as np

from benchmark.manifest import HERE
from benchmark.sim.playback import playback
from benchmark.sim.site import band_recording, draw_site, quantize

SITE = json.loads((HERE / "traffic" / "sweep.json").read_text())["site"]
SHORT = dict(SITE, recording_ms=40)


def test_site_is_deterministic_in_the_seed():
    a, b, c = (draw_site(SHORT, s) for s in (11, 11, 2 ** 31 + 5))
    assert np.array_equal(a.recording, b.recording)
    assert a.cells == b.cells and a.freq_offset == b.freq_offset
    assert not np.array_equal(a.recording, c.recording)
    assert a.recording.shape == c.recording.shape
    assert [x.pci for x in a.cells] == [x.pci for x in c.cells] \
        == [x["pci"] for x in SITE["cells"]]


def test_site_loops_without_a_phase_jump():
    site = draw_site(SHORT, 7)
    n = len(site.recording)
    cycles = site.freq_offset * n / 1.92e6
    assert abs(cycles - round(cycles)) < 1e-9
    timings = sorted(c.timing % 9600 for c in site.cells)
    assert min(np.diff(timings)) >= 9600 // len(timings) - 9600 // 16


def test_band_recording_is_the_dongles():
    site = draw_site(SHORT, 3)
    a = band_recording(3, [1], site, 4096, 3, 0)
    assert np.array_equal(a, band_recording(3, [1], site, 4096, 3, 0))
    assert not np.array_equal(a, band_recording(3, [1], site, 4096, 3, 1))
    assert a.shape == (3, 4096) and a.dtype == np.complex128
    levels = a.real * 128 + 127
    assert np.array_equal(levels, np.round(levels))     # uint8 levels
    assert np.mean(np.abs(a[1]) ** 2) > 3 * np.mean(np.abs(a[0]) ** 2)


def test_playback_is_deterministic_and_loops():
    sig = draw_site(SHORT, 5).recording
    take = [list(itertools.islice(playback(sig, 1e-3, [5, 2]), 9))
            for _ in range(2)]
    assert all(np.array_equal(x, y) for x, y in zip(*take))
    assert all(b.dtype == np.uint8 and b.size == 20000 for b in take[0])
    other = list(itertools.islice(playback(sig, 1e-3, [6, 2]), 1))
    assert not np.array_equal(other[0], take[0][0])


def test_band_quantizer_is_the_frozen_one():
    site = draw_site(SHORT, 9)
    got = band_recording(2, [1], site, 3000, 9, 4)
    rng = np.random.default_rng([9, 0xBA4D, 4])
    scale = np.sqrt(site.noise_power / 2)
    re, im = (rng.standard_normal((2, 3000), dtype=np.float32)
              .astype(np.float64) * scale for _ in range(2))
    n = len(site.recording)
    start = int(rng.integers(0, n))
    iq = site.recording[(start + np.arange(3000)) % n]
    re[1] += iq.real
    im[1] += iq.imag
    assert np.array_equal(got, quantize(re + 1j * im))


def test_the_site_lands_in_both_halves_of_the_band():
    from benchmark.entries import make_entry
    from benchmark.manifest import load_cell
    from benchmark.trace import Spans

    cell = load_cell("band17.sweep")
    placed = [make_entry(cell.config, cell.traffic, seed, "cpu",
                         Spans()).occupied for seed in (5, 5, 2 ** 33 + 1)]
    assert placed[0] == placed[1]
    n = 121
    for first, second in placed:
        assert first == [50]                # 739.0 MHz
        assert len(second) == 1 and n // 2 <= second[0] < n
