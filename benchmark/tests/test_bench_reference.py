"""The reference finds the simulator's planted cells, and its control
(the whole reference in TF32) fails the search cells' ``pss_pow_gap``
and ``foff_gap_hz`` limits, while the float64 reference run again after
it reads no gap at all."""

import json

import numpy as np
import pytest

from benchmark.check import compare_search
from benchmark.manifest import HERE
from benchmark.control import tf32_reference, tf32_round
from benchmark.reference.search import cell_search, search_sets
from benchmark.sim.site import band_recording, draw_site

SITE = dict(json.loads((HERE / "traffic" / "sweep.json").read_text())["site"],
            recording_ms=80)
LIMITS = json.loads((HERE / "configs" / "band17.json").read_text())["check"]


@pytest.fixture(scope="module")
def site_capture():
    site = draw_site(SITE, 424242)
    cap = band_recording(1, [0], site, 153600, 424242, 0)[0]
    _, f_set = search_sets(739e6, 739e6, 10)
    return site, cap, f_set


@pytest.fixture(scope="module")
def found(site_capture):
    site, cap, f_set = site_capture
    return cell_search(cap, 739e6, f_set)


def test_reference_finds_the_planted_cells(site_capture, found):
    site, _, _ = site_capture
    assert sorted(c.n_id_cell() for c in found) \
        == sorted(c.pci for c in site.cells)
    for c in found:
        assert (c.cp_type, c.n_rb_dl, c.n_ports) == ("normal", 50, 1)
        assert abs(c.freq_superfine - site.freq_offset) < 60.0
        assert 0 <= c.sfn < 1024


def test_control_fails_the_scan_power_limit(site_capture, found):
    _, cap, f_set = site_capture
    with tf32_reference():
        control = cell_search(cap, 739e6, f_set)
    numbers = compare_search([(control, found)])
    assert numbers["cells_differ"] == 0
    assert numbers["pss_pow_gap"] > LIMITS["pss_pow_gap"]
    assert numbers["foff_gap_hz"] > LIMITS["foff_gap_hz"]
    again = compare_search([(cell_search(cap, 739e6, f_set), found)])
    assert again == {"cells_differ": 0, "pss_pow_gap": 0.0,
                     "foff_gap_hz": 0.0}


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.14159265])
    assert list(tf32_round(x)[:3]) == [1.0, 1.0 + 2.0 ** -10,
                                       1.0 + 2.0 ** -10]
    assert abs(tf32_round(x)[3] / x[3] - 1) < 2.0 ** -11
