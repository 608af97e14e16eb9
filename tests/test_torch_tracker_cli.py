"""The port's tracker sources, CLI and displays (device="cpu") against the
JAX package's: file playback (tracker/runtime.py ``playback_source``),
the CLI's playback and tracker flags (tracker/cli.py), the status text
(tracker/display.py) and the curses UI's frames and keys
(tracker/curses_display.py).

Tolerances: the playback bytes and every line of text are exact, letter
for letter; the displays of both packages draw one shared snapshot, a
duck-typed tracker holding a port run's status() and cells.
"""

import dataclasses

import numpy as np
import pytest

from lte_cell_scanner_tpu.tracker import curses_display as jax_curses
from lte_cell_scanner_tpu.tracker import display as jax_display
from lte_cell_scanner_tpu.tracker.runtime import \
    playback_source as jax_playback
from lte_cell_scanner_tpu_torch.io.itfile import save_it
from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.tracker import cli, curses_display, display
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)
from torch_one_thread import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sim_signal():
    # tests/test_batch_tracker.py::sim_signal: cell 271 at +4 kHz, 400 ms.
    return synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                             freq_offset=4e3, n_subframes=400,
                             sfn_start=0, seed=5)


@pytest.fixture(scope="module")
def snapshot(sim_signal):
    """A port run (150 blocks, python feeder) frozen into a duck-typed
    tracker: status() and cells, the two things the displays read."""
    trk = LTETracker(739e6, initial_freq_offset=4000.0, drop_threshold=7.5,
                     device="cpu")
    trk.state.debug_g = (0.0, 1.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -3.0)
    trk.run(playback_source(sim_signal), max_blocks=150)
    st = trk.status()

    class Snapshot:
        cells = trk.cells

        @staticmethod
        def status():
            return st

    return Snapshot


# ---------------------------------------------------------------------------
# File playback.


@pytest.mark.parametrize("repeat", [True, False])
@pytest.mark.parametrize("noise_power,seed", [(None, 0), (0.01, 0),
                                              (0.01, 1)])
def test_playback_bytes_match_jax(repeat, noise_power, seed):
    """The same uint8 blocks as the JAX generator (the same rng draws in
    the same order), over the capture's short last block and, repeating,
    over the wrap."""
    rng = np.random.default_rng(7)
    sig = (rng.standard_normal(25000) + 1j * rng.standard_normal(25000)) \
        * 0.3
    got = playback_source(sig, repeat=repeat, noise_power=noise_power,
                          seed=seed)
    want = jax_playback(sig, repeat=repeat, noise_power=noise_power,
                        seed=seed)
    n = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.uint8
        n += 1
        if n == 7:
            break
    assert n == (7 if repeat else 3)
    if not repeat:
        assert len(g) == 2 * 5000 and next(got, None) is None


# ---------------------------------------------------------------------------
# The CLI.


@pytest.fixture(scope="module")
def recordings(sim_signal, tmp_path_factory):
    d = tmp_path_factory.mktemp("tracker_cli")
    save_it(str(d / "sig.it"), {"capbuf": sim_signal})
    iq_to_bytes(sim_signal).tofile(str(d / "sig.raw"))
    return d


def test_cli_load_it_file(recordings, capsys):
    """--load of an .it file, with --drop, --no-repeat, added noise and
    the expert status: cell 271 is acquired and shows in the status rows;
    --g2 lands in the state's debug_g, which the expert status prints."""
    assert cli.main(["-f", "739e6", "--load", str(recordings / "sig.it"),
                     "--drop", "0.01", "--no-repeat", "--noise-power",
                     "0.01", "--blocks", "60", "--expert", "--g2", "1.5",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("[cell_acquired] {'n_id_cell': 271")
               for ln in lines)
    assert any(ln.split()[:1] == ["271"] for ln in lines)
    assert "debug: g2=1.5" in lines
    assert any(ln.startswith("cell 271 port0 |CE|^2 dB") for ln in lines)


def test_cli_load_raw_until_exhausted(recordings, capsys):
    """--load of raw rtl_sdr bytes, --drop and --no-repeat: 271 is
    acquired, and the status loop stops when the 75 blocks of the file
    run out before the first 200-block status."""
    assert cli.main(["-f", "739e6", "--load", str(recordings / "sig.raw"),
                     "--rtl-sdr-format", "--drop", "0.01", "--no-repeat",
                     "--blocks", "200", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[cell_acquired] {'n_id_cell': 271" in out
    assert "CID  P CP" not in out


def test_cli_debug_flags_hidden():
    args = cli.build_parser().parse_args(["-f", "1e9", "--g2", "1.5",
                                          "--g9", "-3"])
    assert tuple(getattr(args, f"g{i}") for i in range(1, 10)) == \
        (0.0, 1.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -3.0)
    assert "--g1" not in cli.build_parser().format_help()


# ---------------------------------------------------------------------------
# Text output against the JAX package's, letter for letter.


def test_snapshot_cells(snapshot):
    """The run behind the text tests: 271 tracked, every measurement the
    detail views draw filled, drop_threshold on the acquired cell."""
    (cell,) = snapshot.cells
    assert cell.n_id_cell == 271 and cell.drop_threshold == 7.5
    for name in ("ce", "ac_fd", "ac_td", "sync_ce", "crs_tp_av"):
        assert getattr(cell, name) is not None, name
    assert snapshot.status()["debug_g"][1] == 1.5


@pytest.mark.parametrize("expert", [False, True])
def test_render_status_matches_jax(snapshot, expert):
    kw = dict(expert=True, tracker=snapshot) if expert else {}
    got = display.render_status(snapshot.status(), **kw)
    assert got == jax_display.render_status(snapshot.status(), **kw)
    assert ("debug: g2=1.5 g9=-3" in got) == expert


@pytest.mark.parametrize("view", curses_display.VIEWS + ("help", "expert"))
def test_render_frame_matches_jax(snapshot, view):
    assert curses_display.VIEWS == jax_curses.VIEWS
    frames = []
    for mod in (curses_display, jax_curses):
        ui = mod.UIState(show_fifo=True)
        if view == "help":
            ui.show_help = True
        elif view == "expert":
            ui.expert = True
        else:
            ui.view = mod.VIEWS.index(view)
        frames.append(mod.render_frame(snapshot, ui, width=100))
    assert frames[0] == frames[1]
    assert any("271" in ln for ln in frames[0])


PLOTS = [
    # (y, x or None, keyword arguments)
    (np.linspace(-45, -3, 72), None,
     dict(x_min=0, x_max=71, x_tick=12, y_min=-50, y_max=0, y_tick=10,
          label="ramp")),
    (40 * np.sin(np.arange(72) / 5.0), None,
     dict(x_min=0, x_max=71, x_tick=12, y_min=-40, y_max=40, y_tick=10,
          connect=False, x_supermark=30.2, width=60, height=9)),
    (np.array([2.0, -3.0, 0.5, 9.0, 0.1]), np.array([4, 0, 2, 3, 1.0]),
     dict(x_min=0, x_max=4, x_tick=1, y_min=0, y_max=1.2, y_tick=0.5)),
    # tests/test_tracker.py::test_plot_trace_degenerate_range
    ([0.5], None, dict(x_min=0.0, x_max=0.0, x_tick=1.0, y_min=0.0,
                       y_max=1.0, y_tick=0.5)),
    ([1.0, 1.0], None, dict(x_min=0.0, x_max=1.0, x_tick=0.5, y_min=1.0,
                            y_max=1.0, y_tick=1.0)),
]


@pytest.mark.parametrize("case", range(len(PLOTS)))
def test_plot_trace_matches_jax(case):
    y, x, kw = PLOTS[case]
    got = display.plot_trace(y, x, **kw)
    assert got == jax_display.plot_trace(y, x, **kw)
    assert "*" in got or "^" in got or "-" in got


def test_handle_key_matches_jax():
    keys = ["l", "l", "j", "j", "k", "KEY_RIGHT", "h", "KEY_LEFT", "+", "+",
            "+", "+", "+", "-", "f", "e", "?", "KEY_DOWN", "KEY_UP", "x",
            "h", "h", "h", "-", "-", "-", "-", "-", "e", "f"]
    ui, ref = curses_display.UIState(), jax_curses.UIState()
    for n_cells in (3, 1, 0):
        for key in keys:
            curses_display.handle_key(ui, key, n_cells)
            jax_curses.handle_key(ref, key, n_cells)
            assert dataclasses.asdict(ui) == dataclasses.asdict(ref), key
