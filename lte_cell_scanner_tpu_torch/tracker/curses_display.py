"""Interactive terminal UI for the realtime tracker.

reference: src/display_thread.cpp (901 LoC ncurses UI). Feature parity:

- main view: global status header + one row per tracked cell (ID, ports,
  CP, bandwidth, frame timing, health %, MIB counts, per-port SNR)
  (display_thread.cpp:108-212),
- detail views per cell: CE transfer-function magnitude and phase per
  port, frequency- and time-domain channel autocorrelations, sync-channel
  SP/NP/TP with the smoothed sync CE (display_thread.cpp:597-757),
- ASCII plot engine (display_thread.cpp:245-370),
- keyboard loop: vim-style navigation (j/k or arrows select a cell,
  h/l or arrows cycle detail views), +/- refresh rate, f FIFO status,
  e expert mode, ? help, q quit (display_thread.cpp:763-898).

The frame renderer is a pure function of (status snapshot, UI state), so
it is testable without a tty; the curses loop is a thin shell around it.
It reads only ``tracker.status()`` and the TrackedCell fields the batched
engine fills. Counterpart of lte_cell_scanner_tpu/tracker/curses_display.py;
its frames are that module's, letter for letter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from lte_cell_scanner_tpu_torch.tracker.display import _fmt, plot_trace

VIEWS = ("summary", "ce_mag", "ce_phase", "ac_fd", "ac_td", "sync")
HELP = [
    "keys:  j/k or up/down   select cell",
    "       h/l or left/right  cycle view "
    "(summary, CE mag, CE phase, AC freq, AC time, sync)",
    "       +/-   faster/slower refresh      f  FIFO status",
    "       e     expert mode (all plots)    ?  toggle this help",
    "       q     quit",
]


@dataclasses.dataclass
class UIState:
    view: int = 0
    selected: int = 0
    refresh_hz: float = 1.0
    expert: bool = False
    show_fifo: bool = False
    show_help: bool = False


def handle_key(ui: UIState, key: str, n_cells: int) -> UIState:
    """Pure keyboard handler (reference: display_thread.cpp:763-898)."""
    if key in ("j", "KEY_DOWN"):
        ui.selected = min(ui.selected + 1, max(0, n_cells - 1))
    elif key in ("k", "KEY_UP"):
        ui.selected = max(ui.selected - 1, 0)
    elif key in ("l", "KEY_RIGHT"):
        ui.view = (ui.view + 1) % len(VIEWS)
    elif key in ("h", "KEY_LEFT"):
        ui.view = (ui.view - 1) % len(VIEWS)
    elif key == "+":
        ui.refresh_hz = min(ui.refresh_hz * 2, 16.0)
    elif key == "-":
        ui.refresh_hz = max(ui.refresh_hz / 2, 0.25)
    elif key == "f":
        ui.show_fifo = not ui.show_fifo
    elif key == "e":
        ui.expert = not ui.expert
    elif key == "?":
        ui.show_help = not ui.show_help
    return ui


def _db10(x):
    return 10 * np.log10(np.abs(np.asarray(x)) ** 2 + 1e-12)


def render_frame(tracker, ui: UIState, width: int = 78) -> List[str]:
    """One full UI frame as a list of lines (pure; no curses)."""
    st = tracker.status()
    cells = tracker.cells
    ui.selected = min(ui.selected, max(0, len(cells) - 1))
    lines = [
        f"LTE-Tracker   FO {st['frequency_offset']:+9.1f} Hz   "
        f"searcher {_fmt(st['searcher_cycle_time'], '.2f')} s   "
        f"drops {st['raw_seconds_dropped']}/{st['cell_seconds_dropped']} s"
        f"   view: {VIEWS[ui.view]}   {ui.refresh_hz:g} Hz   (? for help)",
        "-" * width,
        " CID  P CP  nRB  frame_timing  health   MIBs  SNR(dB)",
    ]
    for i, c in enumerate(st["cells"]):
        sel = ">" if i == ui.selected else " "
        lines.append(
            f"{sel}{c['n_id_cell']:3d}  {c['n_ports']} "
            f"{'N' if c['cp_type'] == 'normal' else 'E':2s} "
            f"{c['n_rb_dl']:4d}  {c['frame_timing']:12.2f}  "
            f"{c['health'] * 100:5.1f}%  {c['mib_successes']:5d}  "
            f"{_fmt(c['sync_snr_db'])}")
        if ui.show_fifo:
            lines.append(f"      fifo peak {c['fifo_peak']}")
    if not st["cells"]:
        lines.append("  (no cells tracked yet — searcher is hunting)")

    if ui.show_help:
        lines.append("-" * width)
        lines.extend(HELP)
        return lines

    if cells and VIEWS[ui.view] != "summary":
        cell = cells[ui.selected]
        lines.append("-" * width)
        lines.extend(_detail_view(cell, VIEWS[ui.view], width))
    if ui.expert and cells:
        cell = cells[ui.selected]
        lines.append("-" * width)
        for v in VIEWS[1:]:
            lines.extend(_detail_view(cell, v, width))
    return lines


def _detail_view(cell, view: str, width: int) -> List[str]:
    """Scaled plot_trace views with the reference UI's fixed ranges
    (src/display_thread.cpp:597-757): CE magnitude -50..0 dB / phase
    +-40 deg with a mean-angle supermark, AC plots on the reference's
    delay-spread / Doppler axes."""
    w = min(width - 2, 77)
    nid = cell.n_id_cell
    if view == "ce_mag":
        if cell.ce is None:
            return [f"cell {nid}: no channel estimate yet"]
        out = []
        for p in range(cell.n_ports):
            out.append(plot_trace(
                _db10(cell.ce[p]), x_min=0, x_max=71, x_tick=12,
                y_min=-50, y_max=0, y_tick=10, width=w, height=9,
                connect=True,
                label=f"cell {nid} port {p} |CE|^2 dB vs subcarrier"))
        return out
    if view == "ce_phase":
        if cell.ce is None:
            return [f"cell {nid}: no channel estimate yet"]
        out = []
        for p in range(cell.n_ports):
            ang = np.angle(cell.ce[p])
            mean_ang = float(np.angle(np.sum(np.exp(1j * ang))))
            out.append(plot_trace(
                np.degrees(ang), x_min=0, x_max=71, x_tick=12,
                y_min=-40, y_max=40, y_tick=10, width=w, height=9,
                connect=False,
                x_supermark=(mean_ang + np.pi) / (2 * np.pi) * 71,
                label=f"cell {nid} port {p} CE phase (deg) "
                      "vs subcarrier"))
        return out
    if view == "ac_fd":
        if cell.ac_fd is None:
            return [f"cell {nid}: no frequency autocorrelation yet"]
        return [plot_trace(
            np.abs(cell.ac_fd), x_min=0, x_max=11, x_tick=2,
            y_min=0, y_max=1.2, y_tick=0.5, width=w, height=9,
            connect=True,
            label=f"cell {nid} |freq-domain CE autocorrelation| "
                  "vs lag (delay spread)")]
    if view == "ac_td":
        if cell.ac_td is None:
            return [f"cell {nid}: no time autocorrelation yet"]
        n = len(cell.ac_td)
        return [plot_trace(
            np.abs(cell.ac_td), np.arange(n) * 0.0005,
            x_min=0, x_max=(n - 1) * 0.0005, x_tick=0.010,
            y_min=0, y_max=3.2, y_tick=0.5, width=w, height=9,
            connect=True,
            label=f"cell {nid} |time-domain CE autocorrelation| "
                  "vs seconds (Doppler)")]
    if view == "sync":
        rows = [
            f"cell {nid} sync channel: "
            f"TP {_fmt(_dbs(cell.sync_tp_av))} dB  "
            f"SP {_fmt(_dbs(cell.sync_sp_av))} dB  "
            f"NP {_fmt(_dbs(cell.sync_np_av))} dB  "
            f"NP(blank) {_fmt(_dbs(cell.sync_np_blank_av))} dB",
        ]
        if cell.crs_tp_av is not None:
            rows.append(
                "CRS per port  TP dB: "
                + "  ".join(_fmt(_dbs(v)) for v in cell.crs_tp_av)
                + "   NP dB: "
                + "  ".join(_fmt(_dbs(v)) for v in cell.crs_np_av))
        if cell.sync_ce is not None:
            rows.append(plot_trace(
                _db10(cell.sync_ce), x_min=0, x_max=71, x_tick=12,
                y_min=-50, y_max=0, y_tick=10, width=w, height=9,
                connect=True,
                label=f"cell {nid} sync channel |CE|^2 dB "
                      "vs subcarrier"))
        return rows
    return []


def _dbs(v):
    if v is None or (isinstance(v, float) and (math.isnan(v) or v <= 0)):
        return float("nan")
    return 10 * math.log10(v)


def run_curses(tracker, source, ui: UIState = None,
               max_blocks: int = None) -> None:
    """Drive the tracker and the interactive display until 'q' or the
    source ends."""
    import curses
    import time

    ui = ui or UIState()

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        done = 0
        it = iter(source)
        while max_blocks is None or done < max_blocks:
            t0 = time.time()
            # ingest for one refresh period
            while time.time() - t0 < 1.0 / ui.refresh_hz:
                try:
                    tracker.step(next(it))
                except StopIteration:
                    return
                done += 1
                if max_blocks is not None and done >= max_blocks:
                    break
            try:
                key = scr.getkey()
            except curses.error:
                key = None
            if key == "q":
                return
            if key:
                handle_key(ui, key, len(tracker.cells))
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            for y, line in enumerate(render_frame(tracker, ui,
                                                  width=maxx - 1)):
                if y >= maxy - 1:
                    break
                scr.addnstr(y, 0, line, maxx - 1)
            scr.refresh()

    curses.wrapper(loop)
