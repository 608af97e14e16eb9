"""Terminal status display for the tracker.

reference: src/display_thread.cpp (ncurses realtime UI with per-cell rows,
ASCII plots of CE magnitude/phase and autocorrelations, expert mode).
Draws the same information from LTETracker.status() as plain text
(loggable), or live through ``rich`` where it is installed; the curses UI
(tracker/curses_display.py) draws its plots with :func:`plot_trace`.
The text is the JAX package's (lte_cell_scanner_tpu/tracker/display.py),
letter for letter.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _fmt(v, spec=".1f", nan="  -  "):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return nan
    return format(v, spec)


def plot_trace(y, x=None, *, x_min: float, x_max: float, x_tick: float,
               y_min: float, y_max: float, y_tick: float,
               width: int = 77, height: int = 10,
               x_supermark: float = float("nan"),
               connect: bool = True, label: str = "") -> str:
    """Scaled-axes ASCII trace plot — the text-mode equivalent of the
    reference's plot_trace engine (src/display_thread.cpp:245-370):
    fixed x/y ranges, a 5-column y-axis gutter with right-aligned tick
    labels, tick marks on both axes, an optional x-axis supermark ('*'),
    linear interpolation of the trace onto the plot columns,
    out-of-range clamping drawn as '^' (above) / '-' (below), and
    optional connect-the-dots vertical fill ('.')."""
    gutter = 5
    plot_w = max(8, width - gutter)
    plot_h = max(3, height - 1)
    y = np.asarray(y, dtype=float).ravel()
    x = (np.linspace(x_min, x_max, len(y)) if x is None
         else np.asarray(x, dtype=float).ravel())
    grid = [[" "] * plot_w for _ in range(plot_h)]

    # Trace: interp1 onto the plot columns (reference: linspace+interp1).
    xs = np.linspace(x_min, x_max, plot_w)
    order = np.argsort(x)
    ys = np.interp(xs, x[order], y[order], left=np.nan, right=np.nan)
    ys = np.where((xs >= x.min()) & (xs <= x.max()), ys, np.nan)
    # Degenerate ranges (e.g. a length-1 ac_td trace gives x_max==x_min
    # from the curses view's (n-1)*0.0005 formula) must not divide by 0.
    y_scale = max(y_max - y_min, 1e-12) / (plot_h - 1)
    prev_row = None
    for t in range(plot_w):
        if not np.isfinite(ys[t]):
            prev_row = None
            continue
        row = int(round((plot_h - 1) - (ys[t] - y_min) / y_scale))
        ch = "*"
        if row < 0:
            row, ch = 0, "^"
        elif row > plot_h - 1:
            row, ch = plot_h - 1, "-"
        grid[row][t] = ch
        if connect and prev_row is not None and abs(row - prev_row) > 1:
            step = 1 if row > prev_row else -1
            mid = round((prev_row + row) / 2)
            for k in range(prev_row + step, row, step):
                col = (t - 1 if (k < mid) == (step == 1) else t)
                if grid[k][max(0, col)] == " ":
                    grid[k][max(0, col)] = "."
        prev_row = row

    # Axes: y gutter with tick labels, x axis line with tick marks.
    lines = [label] if label else []
    ytick_rows = {}
    ty = math.ceil(y_min / y_tick) * y_tick
    while ty <= y_max + 1e-9:
        r = int(round((plot_h - 1) - (ty - y_min) / y_scale))
        if 0 <= r <= plot_h - 1:
            ytick_rows[r] = f"{ty:4.4g}"[:4]
        ty += y_tick
    for r in range(plot_h):
        lbl = ytick_rows.get(r)
        gut = (f"{lbl:>4}+" if lbl is not None else "    |")
        lines.append(gut + "".join(grid[r]))
    axis = [" "] * plot_w
    tx = math.ceil(x_min / x_tick) * x_tick
    x_scale = max(x_max - x_min, 1e-12) / (plot_w - 1)
    while tx <= x_max + 1e-9:
        c = int(round((tx - x_min) / x_scale))
        if 0 <= c <= plot_w - 1:
            axis[c] = "+"
        tx += x_tick
    if np.isfinite(x_supermark):
        c = int(round((x_supermark - x_min) / x_scale))
        if 0 <= c <= plot_w - 1:
            axis[c] = "*"
    lines.append("    +" + "".join(
        ch if ch != " " else "-" for ch in axis))
    lines.append("     " + f"{x_min:<8.4g}" + " " * max(
        0, plot_w - 16) + f"{x_max:>8.4g}")
    return "\n".join(lines)


def ascii_plot(values: np.ndarray, width: int = 60, height: int = 8,
               label: str = "") -> str:
    """Tiny ASCII plot engine (reference: display_thread.cpp:245-370)."""
    values = np.asarray(values, dtype=float)
    values = values[np.isfinite(values)]
    if values.size == 0:
        return f"{label}: (no data)"
    if len(values) > width:
        idx = np.linspace(0, len(values) - 1, width).astype(int)
        values = values[idx]
    lo, hi = float(values.min()), float(values.max())
    span = (hi - lo) or 1.0
    rows = [[" "] * len(values) for _ in range(height)]
    for x, v in enumerate(values):
        y = int((v - lo) / span * (height - 1))
        rows[height - 1 - y][x] = "*"
    out = [f"{label}  [{lo:.3g} .. {hi:.3g}]"]
    out += ["|" + "".join(r) for r in rows]
    return "\n".join(out)


def render_status(status: dict, expert: bool = False,
                  tracker=None) -> str:
    """One status frame as text."""
    lines = []
    lines.append(
        f"FO: {status['frequency_offset']:+9.1f} Hz   "
        f"searcher cycle: {_fmt(status['searcher_cycle_time'], '.2f')} s   "
        f"drops raw/cell: {status['raw_seconds_dropped']}"
        f"/{status['cell_seconds_dropped']} s")
    lines.append("CID  P CP  nRB  frame_timing  health  MIBs  fifo^  SNR(dB)")
    for c in status["cells"]:
        lines.append(
            f"{c['n_id_cell']:3d}  {c['n_ports']} "
            f"{'N' if c['cp_type'] == 'normal' else 'E':2s} "
            f"{c['n_rb_dl']:4d}  {c['frame_timing']:12.2f}  "
            f"{c['health'] * 100:5.1f}%  {c['mib_successes']:4d}  "
            f"{c['fifo_peak']:5d}  {_fmt(c['sync_snr_db'])}")
    if not status["cells"]:
        lines.append("  (no cells tracked)")

    if expert and any(status.get("debug_g", ())):
        gs = " ".join(f"g{i + 1}={v:g}"
                      for i, v in enumerate(status["debug_g"]) if v)
        lines.append(f"debug: {gs}")
    if expert and tracker is not None:
        for cell in tracker.cells:
            if cell.ce is not None:
                lines.append(ascii_plot(
                    10 * np.log10(np.abs(cell.ce[0]) ** 2 + 1e-12),
                    label=f"cell {cell.n_id_cell} port0 |CE|^2 dB"))
            if cell.ac_td is not None:
                lines.append(ascii_plot(
                    np.abs(cell.ac_td),
                    label=f"cell {cell.n_id_cell} |time autocorrelation|"))
            if cell.ac_fd is not None:
                lines.append(ascii_plot(
                    np.abs(cell.ac_fd),
                    label=f"cell {cell.n_id_cell} |freq autocorrelation|"))
    return "\n".join(lines)


def live_display(tracker, refresh_hz: float = 1.0,
                 duration: Optional[float] = None) -> None:
    """Live updating display through ``rich`` where it is installed; else
    a periodic print of the same frame."""
    import time

    try:
        from rich.live import Live
        from rich.text import Text
    except ImportError:
        Live = None
    t0 = time.time()
    if Live is None:
        while duration is None or time.time() - t0 < duration:
            print(render_status(tracker.status()))
            time.sleep(1.0 / refresh_hz)
        return
    with Live(refresh_per_second=refresh_hz) as live:
        while duration is None or time.time() - t0 < duration:
            live.update(Text(render_status(tracker.status())))
            time.sleep(1.0 / refresh_hz)
