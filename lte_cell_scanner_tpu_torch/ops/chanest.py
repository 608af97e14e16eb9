"""Hex (Delaunay) channel-estimate interpolation geometry.

reference: src/searcher.cpp:1200-1362 (the reference's enabled
interpolator). Between two adjacent RS rows the triangle-strip sweep is a
fixed LINEAR map of the two rows' 2x12 filtered estimates, so it is probed
once per lattice geometry; ops/mib_torch.py::_hex_interp_tabs builds the
device tables from these maps.
"""

from __future__ import annotations

import functools

import numpy as np


def _hex_extend(row_x: np.ndarray, row_val: np.ndarray):
    """Extrapolate so each RS row has vertices at subcarriers 0 and 71.

    reference: src/searcher.cpp:1200-1213.
    """
    row_x = list(row_x)
    row_val = list(row_val)
    if row_x[0] != 0:
        v = row_val[0] - row_x[0] * (row_val[1] - row_val[0]) / (row_x[1] - row_x[0])
        row_x.insert(0, 0.0)
        row_val.insert(0, v)
    if row_x[-1] != 71:
        v = row_val[-1] + (71 - row_x[-1]) * (row_val[-1] - row_val[-2]) / (
            row_x[-1] - row_x[-2])
        row_x.append(71.0)
        row_val.append(v)
    return np.array(row_x), np.array(row_val)


def _hex_fill_pair(top_v, bot_v, top_shift, bot_shift, spacing):
    """Exact scalar triangle-strip fill for ONE pair of adjacent RS rows
    (rows 1..spacing between them). Extracted from the reference sweep
    (src/searcher.cpp:1223-1362); used directly and as the probe for the
    cached linear map below."""
    top_x, top_v = _hex_extend(
        np.arange(top_shift, 72, 6, dtype=np.float64), top_v)
    bot_x, bot_v = _hex_extend(
        np.arange(bot_shift, 72, 6, dtype=np.float64), bot_v)
    y_top, y_bot = 0.0, float(spacing)
    out = np.empty((spacing, 72), dtype=np.asarray(top_v).dtype)

    if top_x[1] < bot_x[1]:
        tri = [(top_x[0], y_top, top_v[0]), (bot_x[0], y_bot, bot_v[0]),
               (top_x[1], y_top, top_v[1])]
        top_used, bot_used = 1, 0
    else:
        tri = [(bot_x[0], y_bot, bot_v[0]), (top_x[0], y_top, top_v[0]),
               (bot_x[1], y_bot, bot_v[1])]
        top_used, bot_used = 0, 1

    x_offset = np.zeros(spacing + 1, dtype=np.int64)
    while True:
        (x0, y0, v0), (x1, y1, v1), (x2, y2, v2) = tri
        det = (x0 * (y1 - y2) + x1 * (y2 - y0) + x2 * (y0 - y1))
        a = (v0 * (y1 - y2) + v1 * (y2 - y0) + v2 * (y0 - y1)) / det
        b = (v0 * (x2 - x1) + v1 * (x0 - x2) + v2 * (x1 - x0)) / det
        c = (v0 * (x1 * y2 - x2 * y1) + v1 * (x2 * y0 - x0 * y2)
             + v2 * (x0 * y1 - x1 * y0)) / det
        a_l = (x1 - x2) / (y1 - y2)
        b_l = (y1 * x2 - y2 * x1) / (y1 - y2)

        for r in range(1, spacing + 1):
            limit = a_l * r + b_l
            hi = min(int(np.floor(limit)), 71)
            lo = x_offset[r]
            if hi >= lo:
                xs = np.arange(lo, hi + 1)
                out[r - 1, lo:hi + 1] = a * xs + b * r + c
                x_offset[r] = hi + 1

        if x_offset[1] == 72 and x_offset[spacing] == 72:
            break
        if tri[2][1] == y_top:
            bot_used += 1
            nxt = (bot_x[bot_used], y_bot, bot_v[bot_used])
        else:
            top_used += 1
            nxt = (top_x[top_used], y_top, top_v[top_used])
        tri = [tri[1], tri[2], nxt]
    return out


@functools.lru_cache(maxsize=64)
def _hex_pair_map(top_shift: int, bot_shift: int, spacing: int) -> np.ndarray:
    """(spacing*72, 24) linear map from the pair's 2x12 raw CE values to
    the interpolated grid rows. The fill (planes + edge extrapolation) is
    linear in the values, so probing the exact scalar implementation with
    the 24 basis vectors captures it exactly."""
    w = np.empty((spacing * 72, 24))
    for i in range(24):
        basis = np.zeros(24)
        basis[i] = 1.0
        out = _hex_fill_pair(basis[:12].copy(), basis[12:].copy(),
                             top_shift, bot_shift, spacing)
        w[:, i] = out.reshape(-1)
    return w
