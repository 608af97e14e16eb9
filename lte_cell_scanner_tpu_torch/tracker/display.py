"""Plain-text status display for the tracker.

reference: src/display_thread.cpp (per-cell rows of the realtime UI).
Draws one status frame from LTETracker.status() as loggable text.
"""

from __future__ import annotations

import math

import numpy as np


def _fmt(v, spec=".1f", nan="  -  "):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return nan
    return format(v, spec)


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


def render_status(status: dict) -> str:
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
    return "\n".join(lines)
