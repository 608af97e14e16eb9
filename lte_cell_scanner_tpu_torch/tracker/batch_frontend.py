"""Batched (multi-cell) tracker math on the device.

Counterpart of lte_cell_scanner_tpu/tracker/batch_frontend.py. Every
per-symbol / per-RS computation of the reference's tracker thread
(src/tracker_thread.cpp) as fixed-shape tensor math with the cell axis
vectorized; the sequential control flow (FIFO bookkeeping, inverse-
variance feedback blends, health counters) stays on the host in
tracker/batch_runtime.py.

All device functions take and return split re/im planes (trailing axis
2). The tables are built in numpy on the host (float32, the same code as
the JAX package's) and cached per device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import FS_LTE
from lte_cell_scanner_tpu_torch.ops.sync_torch import cabs2, cconj, cmul


def to_ri(x: np.ndarray) -> np.ndarray:
    return np.stack([np.real(x), np.imag(x)], axis=-1).astype(np.float32)


def from_ri(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x[..., 0] + 1j * x[..., 1]


@functools.lru_cache(maxsize=32)
def on_device(table, device: torch.device, *args):
    """The numpy tables returned by ``table(*args)`` as tensors on
    ``device``."""
    got = table(*args)
    if isinstance(got, np.ndarray):
        return torch.from_numpy(got).to(device)
    return tuple(torch.from_numpy(m).to(device) for m in got)


# ----------------------------------------------------------------------
# get_fd: FOC + 2-sample TOC + DFT(128 -> 72 SC) + phase compensation.

_BINS = np.concatenate([np.arange(92, 128), np.arange(1, 37)])


class SubcarrierDFT(NamedTuple):
    """A 128 -> len(bins) DFT named by its output bins and the cyclic
    shift of its input window: y = x @ (wr + i*wi) with

        W[t, k] = exp(-2*pi*i*((t - shift) mod 128)*bins[k]/128) / sqrt(128),

    the unitary DFT, at ``bins``, of x rotated left by ``shift`` samples
    (x[(u + shift) % 128] at lane u). The symbol-demod kernel
    computes it as a 128-point FFT, the bin selection and the per-bin
    factor exp(+2*pi*i*shift*bins[k]/128) / sqrt(128)."""

    bins: Tuple[int, ...]
    shift: int


# The search chain's extract_tfg (ops/mib_torch.py) and the tracker's
# get_fd, whose 2-sample TOC rotate is the shift.
MIB_DFT = SubcarrierDFT(tuple(int(b) for b in _BINS), 0)
TRACKER_DFT = SubcarrierDFT(tuple(int(b) for b in _BINS), 2)


def dft_mats(dft: SubcarrierDFT):
    """(128, K) cos/sin of ``dft``, built in float64 and rounded to f32."""
    t = np.arange(128)[:, None]
    k = np.asarray(dft.bins)[None, :]
    w = np.exp(-2j * np.pi * ((t - dft.shift) % 128) * k / 128.0) \
        / np.sqrt(128.0)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def dft_cn(dft: SubcarrierDFT) -> np.ndarray:
    """(K,) f32 signed subcarrier index of each bin (bin - 128 above 63)."""
    b = np.asarray(dft.bins)
    return np.where(b < 64, b, b - 128).astype(np.float32)


def get_fd_batch(data, foc_rate, bpo, late, j=None):
    """Symbol demod for a batch of 128-sample windows.

    data:     (..., 128, 2) f32 — raw symbol windows.
    foc_rate: (...,) f32 — -2*pi*fo/(fs_programmed*k_factor) per window.
    bpo:      (...,) f32 — accumulated bulk phase offset to apply
              (host-precomputed in float64, already includes this
              window's increment; reference: src/tracker_thread.cpp:
              151-171).
    late:     (...,) f32 — fractional timing for the phase ramp.
    j:        optional (..., 128) f32 — per-lane original sample index
              when ``data`` is an aligned-blend window
              (ops/sync_torch._aligned_wins); the caller must already
              have folded the blend's b offset into ``late``.

    Returns syms (..., 72, 2).
    """
    dev = data.device
    t = torch.arange(128, dtype=data.dtype, device=dev) if j is None else j
    ph = foc_rate[..., None] * t                      # (..., 128)
    x = cmul(data, torch.stack([torch.cos(ph), torch.sin(ph)], dim=-1))

    wr, wi = on_device(dft_mats, dev, TRACKER_DFT)
    # y = x @ W (the 2-sample rotation lives inside W)
    yr = x[..., 0] @ wr - x[..., 1] @ wi
    yi = x[..., 0] @ wi + x[..., 1] @ wr

    # Fractional-timing ramp + bulk phase in one rotation per subcarrier.
    cn = on_device(dft_cn, dev, TRACKER_DFT)
    ang = bpo[..., None] - 2 * np.pi * late[..., None] * cn / 128.0
    rot = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    return cmul(torch.stack([yr, yi], dim=-1), rot)


def bulk_phase_offsets(bpo0: np.ndarray, fo: np.ndarray,
                       n_samp_elapsed: np.ndarray) -> np.ndarray:
    """Host-side float64 bulk-phase accumulation (the drift-sensitive
    quantity — kept in f64 exactly because the reference's f32-style
    accumulation drifts, doc/LTE-Tracker.html:89-90).

    bpo0 (C,), fo (C, S), n_samp_elapsed (C, S) -> bpo (C, S) to pass to
    get_fd_batch, plus the final carry (C,).
    """
    inc = 2 * np.pi * n_samp_elapsed * (1.0 / (FS_LTE / 16)) * (-fo)
    acc = bpo0[:, None] + np.cumsum(inc, axis=1)
    acc = np.mod(acc + np.pi, 2 * np.pi) - np.pi
    return acc, acc[:, -1]


# ----------------------------------------------------------------------
# Raw CE extraction at RS positions.


def raw_ce_batch(syms, rs_conj, shift):
    """ce_raw = syms[shift::6] * conj(rs).

    syms (..., 72, 2); rs_conj (..., 12, 2) — conj of the RS sequence;
    shift (...,) int in [0, 6). Returns (..., 12, 2).
    """
    batch = torch.broadcast_shapes(syms.shape[:-2], shift.shape)
    idx = shift.long()[..., None] + 6 * torch.arange(12, device=syms.device)
    idx = idx.expand(*batch, 12)[..., None].expand(*batch, 12, 2)
    got = torch.gather(syms.expand(*batch, 72, 2), -2, idx)
    return cmul(got, rs_conj)


# ----------------------------------------------------------------------
# 3-symbol CE filter + noise/signal power (filter_ce, tracker_thread.cpp
# :176-202 and :912-932).


@functools.lru_cache(maxsize=1)
def _filter_mats():
    """Averaging matrices: curr (12,12) over {t-1,t,t+1}; lohi (12,12)
    over {t,t+1} (prev shift < curr); hilo over {t-1,t}; plus counts."""
    curr = np.zeros((12, 12), np.float32)
    lohi = np.zeros((12, 12), np.float32)
    hilo = np.zeros((12, 12), np.float32)
    n_curr = np.zeros(12, np.float32)
    n_lohi = np.zeros(12, np.float32)
    n_hilo = np.zeros(12, np.float32)
    for t in range(12):
        for i in (t - 1, t, t + 1):
            if 0 <= i < 12:
                curr[t, i] = 1
                n_curr[t] += 1
        for i in (t, t + 1):
            if 0 <= i < 12:
                lohi[t, i] = 1
                n_lohi[t] += 1
        for i in (t - 1, t):
            if 0 <= i < 12:
                hilo[t, i] = 1
                n_hilo[t] += 1
    return curr, lohi, hilo, n_curr, n_lohi, n_hilo


def _mat(ce, m):
    """Apply a real (n, n) matrix along the subcarrier axis of (..., n, 2)."""
    return torch.stack([ce[..., 0] @ m.T, ce[..., 1] @ m.T], dim=-1)


def _neighbours(x):
    """x[t-1] and x[t+1] along the subcarrier axis of (..., n, 2), zero
    beyond the band's edges."""
    z = torch.zeros_like(x[..., :1, :])
    return (torch.cat([z, x[..., :-1, :]], dim=-2),
            torch.cat([x[..., 1:, :], z], dim=-2))


def filter_ce_batch(ce_prev, ce_curr, ce_next, prev_lower):
    """3-symbol staggered-comb filter + bias-corrected powers.

    ce_* (..., 12, 2); prev_lower (...,) bool — True when the previous
    RS symbol's shift is below the current one. Returns
    (ce_filt (...,12,2), np_curr, tp_curr, sp_curr, sp_raw).

    The band sums of :func:`_filter_mats` (curr over {t-1, t, t+1}, lohi
    over {t, t+1}, hilo over {t-1, t}) are taken as neighbour additions in
    that order, not as matrix products: each row's value then does not
    depend on how many rows a call holds (a GEMM kernel chosen by the row
    count may sum in another order), so a cycle split over devices gives
    the unsplit cycle's bits.
    """
    _, _, _, n_curr, n_lohi, n_hilo = on_device(_filter_mats,
                                                ce_curr.device)
    adj = ce_prev + ce_next
    c_lo, c_hi = _neighbours(ce_curr)
    a_lo, a_hi = _neighbours(adj)
    curr = c_lo + ce_curr + c_hi
    tot_lo = curr + (adj + a_hi)
    tot_hi = curr + (a_lo + adj)
    cnt_lo = n_curr + 2 * n_lohi
    cnt_hi = n_curr + 2 * n_hilo
    pl = prev_lower[..., None, None]
    ce_filt = torch.where(pl, tot_lo / cnt_lo[:, None],
                          tot_hi / cnt_hi[:, None])

    np_curr = torch.mean(cabs2(ce_curr - ce_filt), dim=-1) * (7.0 / 6.0)
    tp_curr = torch.mean(cabs2(ce_filt), dim=-1)
    sp_raw = tp_curr - np_curr / 7.0
    sp_curr = torch.clamp(sp_raw, min=1e-5)
    return ce_filt, np_curr, tp_curr, sp_curr, sp_raw


# ----------------------------------------------------------------------
# FOE / TOE raw estimates (the feedback blends stay on host).


def foe_stats_batch(ce_prev, ce_next, ce_filt, np_curr):
    """MRC frequency-offset statistic (do_foe, tracker_thread.cpp:204-243).

    Returns (foe_comb (...,2), foe_comb_np (...,)) — the complex rotation
    estimate and its noise power; the host converts angle -> Hz with its
    own f64 timestamps and blends into the global FO.
    """
    foe = cmul(cconj(ce_prev), ce_next)                    # (..., 12, 2)
    cf2 = cabs2(ce_filt)
    foe_np = np_curr[..., None] ** 2 + 2 * np_curr[..., None] * cf2
    weight = cf2 / foe_np
    foe_comb = torch.sum(foe * weight[..., None], dim=-2)
    foe_comb_np = torch.sum(foe_np * weight * weight, dim=-1)
    scale = 1.0 / torch.sum(cf2 * weight, dim=-1)
    return foe_comb * scale[..., None], foe_comb_np * scale * scale


def toe_stats_batch(ce_prev, ce_curr, sp_curr, np_curr, prev_lower):
    """Staggered-RS timing estimate (do_toe_v2, tracker_thread.cpp:245-279).

    Returns (delay (...,), delay_np (...,)) in samples.
    """
    pl = prev_lower[..., None, None]
    a = torch.where(pl, ce_prev, ce_curr)
    b = torch.where(pl, ce_curr, ce_prev)
    toe1 = torch.sum(cmul(cconj(a), b), dim=-2) / 12.0
    t2a = torch.sum(cmul(cconj(b[..., 0:5, :]), a[..., 1:6, :]), dim=-2)
    t2b = torch.sum(cmul(cconj(b[..., 6:11, :]), a[..., 7:12, :]), dim=-2)
    toe2 = (t2a + t2b) / 10.0
    ang1 = torch.atan2(toe1[..., 1], toe1[..., 0])
    ang2 = torch.atan2(toe2[..., 1], toe2[..., 0])
    delay = -(ang1 + ang2) / 2.0 / 3.0 / (2 * np.pi / 128.0)
    delay_np = torch.clamp(np_curr / sp_curr / 2.0 / 12.0, min=0.001)
    return delay, delay_np


def ac_fd_batch(ce_curr, sp_curr, np_curr):
    """Frequency-domain CE autocorrelation (do_ac_fd, :318-340).

    Returns (ac (...,12,2), ac_np (...,12))."""
    outs = []
    for d in range(12):
        prod = cmul(cconj(ce_curr[..., :12 - d, :]), ce_curr[..., d:, :])
        outs.append(torch.mean(prod, dim=-2))
    ac = torch.stack(outs, dim=-2) / sp_curr[..., None, None]
    denom = torch.arange(12, 0, -1, dtype=ce_curr.dtype,
                         device=ce_curr.device)
    ac_np = ((np_curr ** 2 / sp_curr ** 2
              + 2 * np_curr / sp_curr)[..., None] / denom)
    return ac, ac_np


# ----------------------------------------------------------------------
# Sync-channel (PSS/SSS) measurements (tracker_thread.cpp:754-820).


@functools.lru_cache(maxsize=1)
def _smooth62():
    m = np.zeros((62, 62), np.float32)
    for t in range(62):
        lt, rt = max(0, t - 6), min(t + 6, 61)
        m[t, lt:rt + 1] = 1.0 / (2 * (rt - lt + 1))
    return m


def sync_meas_batch(pss_sym, sss_sym, pss_conj, sss_seq):
    """SP/NP/TP + smoothed CE from one PSS/SSS symbol pair.

    pss_sym/sss_sym (..., 72, 2); pss_conj (..., 62, 2) — conj(PSS_fd);
    sss_seq (..., 62) — the +/-1 SSS. Returns dict of measurements.
    """
    def power(x):
        return torch.mean(cabs2(x), dim=-1)

    np_blank = (power(sss_sym[..., 0:5, :]) + power(sss_sym[..., 67:72, :])
                + power(pss_sym[..., 0:5, :])
                + power(pss_sym[..., 67:72, :])) / 4.0
    ce_sss = sss_sym[..., 5:67, :] * sss_seq[..., None]
    ce_pss = cmul(pss_sym[..., 5:67, :], pss_conj)
    m = on_device(_smooth62, pss_sym.device)
    ce_smooth = _mat(ce_sss, m) + _mat(ce_pss, m)
    np_est = (power(ce_smooth - ce_sss) * 13 / 12
              + power(ce_smooth - ce_pss) * 13 / 12) / 2.0
    tp = power(ce_smooth)
    sp = tp - np_est / 13.0
    return {"tp": tp, "sp": sp, "np": np_est, "np_blank": np_blank,
            "ce_smooth": ce_smooth}
