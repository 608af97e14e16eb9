"""Batched SSS detection + fine FOE on the device.

Counterpart of lte_cell_scanner_tpu/ops/sync_jax.py (reference:
src/searcher.cpp:533-850, sss_detect_getce_sss / sss_detect_ml /
sss_detect / pss_sss_foe). Every candidate peak of a capture runs at once:

- the per-repetition PSS/SSS windows are cut from 128-aligned rows
  (:func:`_aligned_wins`) and taken to the 62 sync bins with one DFT
  matrix product;
- the 168 x 2 orderings x {normal, extended} ML hypothesis scan is four
  batched products against the (168, 124) SSS table;
- the fine FOE is evaluated for all four (ordering, CP) combinations at
  window locations planned on the host in float64 (:func:`sync_plan`),
  and the detected combination is picked on the device.

Complex values are split (..., 2) re/im planes in float32, as in the JAX
program, so the two agree to float32 rounding.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lte_cell_scanner_tpu_torch.constants import FS_LTE, HALF_FRAME
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.models.pss import pss_fd
from lte_cell_scanner_tpu_torch.models.sss import sss_fd_all
from lte_cell_scanner_tpu_torch.utils.device import (HostFetch, to_host,
                                                     upload)
from lte_cell_scanner_tpu_torch.utils.dsp import wrap

N_REP = 16   # PSS repetitions in an 80 ms capture (ceil(153600/9600))


def _n_rep_for(n_cap: int) -> int:
    """Repetition-axis size for a capture: all 16 half-frames of an 80 ms
    capture, growing in steps of 4 for longer ones (the host path combines
    EVERY repetition)."""
    need = -(-n_cap // HALF_FRAME)
    return max(N_REP, -(-need // 4) * 4)


# ----------------------------------------------------------------------
# Complex helpers on (..., 2) split planes.


def cmul(a, b):
    re = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    im = a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
    return torch.stack([re, im], dim=-1)


def cconj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def cabs2(a):
    return a[..., 0] ** 2 + a[..., 1] ** 2


def rot_pair(ang):
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


# ----------------------------------------------------------------------
# Constant tables.


@functools.lru_cache(maxsize=1)
def _dft62():
    """(128, 62) unitary DFT restricted to the 62 sync bins with the
    2-sample timing-margin rotation folded in."""
    bins = np.concatenate([np.arange(97, 128), np.arange(1, 32)])
    t = np.arange(128)[:, None]
    w = np.exp(-2j * np.pi * ((t - 2) % 128) * bins[None, :] / 128.0)
    w = w / np.sqrt(128.0)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _smooth13_mat():
    """(62, 62) frequency smoother: out[t] = mean(h[max(0,t-6):min(61,t+6)+1])."""
    m = np.zeros((62, 62), np.float32)
    for t in range(62):
        lt, rt = max(0, t - 6), min(61, t + 6)
        m[t, lt:rt + 1] = 1.0 / (rt - lt + 1)
    return m


@functools.lru_cache(maxsize=1)
def _pss_fd_conj():
    """(3, 62, 2) conj(PSS_fd) split planes."""
    t = np.stack([np.conj(pss_fd(i)) for i in range(3)])
    return np.stack([t.real, t.imag], -1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _sss_tables():
    """(3, 168, 2, 62) float32 +/-1 SSS table for each n_id_2."""
    return np.stack([sss_fd_all(i) for i in range(3)]).astype(np.float32)


_CN62 = np.concatenate([np.arange(97, 128) - 128,
                        np.arange(1, 32)]).astype(np.float32)


# ----------------------------------------------------------------------
# Host-side plan (float64 index arithmetic).


@dataclasses.dataclass
class SyncPlan:
    """Arrays driving the device program (leading axis B = candidates);
    the field names and arrays of the JAX package's SyncPlan."""

    pss_idx: np.ndarray      # (B, R) i32 — PSS DFT window starts
    rep_mask: np.ndarray     # (B, R) f32
    foc: np.ndarray          # (B,) f32 — -peak_freq
    inv_fs: np.ndarray       # (B,) f32 — 1 / fs_eff
    n_id_2: np.ndarray       # (B,) i32
    foe_pss: np.ndarray      # (B, 2, 2, R) i32 (ordering, cp)
    foe_sss: np.ndarray      # (B, 2, 2, R) i32
    foe_mask: np.ndarray     # (B, 2, 2, R) f32
    foe_seq: np.ndarray      # (B, 2, 2, R) i32 — 0: slot-0 SSS, 1: slot-10
    foe_phase: np.ndarray    # (B, 2, 2) f32 — phase const angle per (o, cp)
    foe_conv: np.ndarray     # (B, 2) f32 — fs_eff / (2 pi dist) per cp
    freq: np.ndarray         # (B,) f64 — coarse peak freq
    frame_start: np.ndarray  # (B, 2) f64 — candidate per ordering
    valid: np.ndarray        # (B,) bool


def sync_plan(cells: Sequence[Cell], n_cap: int,
              cap_bases: Optional[Sequence[int]] = None) -> SyncPlan:
    """Float64 window-location plan for a batch of candidate peaks (the
    index arithmetic of the host sss_detect / pss_sss_foe, native mode).
    fc/fs are taken per cell.

    ``n_cap`` is the length of ONE capture. ``cap_bases`` (per cell)
    offsets every window into a stack of captures of that length laid end
    to end, so that a whole sweep's candidates run in one program; the
    range checks stay within each cell's own capture.
    """
    n = len(cells)
    R = _n_rep_for(n_cap)
    p = SyncPlan(
        pss_idx=np.zeros((n, R), np.int32),
        rep_mask=np.zeros((n, R), np.float32),
        foc=np.zeros(n, np.float32),
        inv_fs=np.zeros(n, np.float32),
        n_id_2=np.zeros(n, np.int32),
        foe_pss=np.zeros((n, 2, 2, R), np.int32),
        foe_sss=np.zeros((n, 2, 2, R), np.int32),
        foe_mask=np.zeros((n, 2, 2, R), np.float32),
        foe_seq=np.zeros((n, 2, 2, R), np.int32),
        foe_phase=np.zeros((n, 2, 2), np.float32),
        foe_conv=np.zeros((n, 2), np.float32),
        freq=np.zeros(n, np.float64),
        frame_start=np.zeros((n, 2), np.float64),
        valid=np.ones(n, bool),
    )
    fc_req = np.array([c.fc_requested for c in cells], np.float64)
    fc_prog = np.array([c.fc_programmed for c in cells], np.float64)
    fs_prog = np.array([c.fs_programmed for c in cells], np.float64)
    freq = np.array([c.freq for c in cells], np.float64)
    ind = np.array([c.ind for c in cells], np.float64)
    base_v = (np.zeros(n, np.int64) if cap_bases is None
              else np.asarray(list(cap_bases)[:n], np.int64))
    ii = np.arange(R, dtype=np.float64)[None, :]            # (1, R)

    k_factor = (fc_req - freq) / fc_prog
    fs_eff = fs_prog * k_factor
    u = 16.0 / FS_LTE * fs_prog * k_factor
    peak_loc = np.where(ind + 9 < 162, ind + HALF_FRAME * k_factor, ind)

    # --- detection windows
    step = k_factor * HALF_FRAME
    n_in_range = np.floor((n_cap - 125 - 9 - peak_loc) / step)
    pss_loc = peak_loc[:, None] + step[:, None] * ii
    locs = np.round(pss_loc).astype(np.int64) + 9 - 2
    rep_ok = (ii <= n_in_range[:, None]) & (locs + 128 <= n_cap)
    p.pss_idx[:] = np.where(rep_ok, locs + base_v[:, None], 0)
    p.rep_mask[:] = rep_ok
    p.foc[:] = -freq
    p.inv_fs[:] = 1.0 / fs_eff
    p.n_id_2[:] = [c.n_id_2 for c in cells]
    p.freq[:] = freq

    # --- frame_start candidates per ordering
    fs_base = peak_loc + (128 + 9 - 960 - 2) * u
    p.frame_start[:, 0] = wrap(fs_base, -0.5, 2 * HALF_FRAME - 0.5)
    p.frame_start[:, 1] = wrap(fs_base + HALF_FRAME * u, -0.5,
                               2 * HALF_FRAME - 0.5)

    # --- FOE windows for every (ordering, cp) combo
    for ci, cp_type in enumerate(("normal", "extended")):
        if cp_type == "normal":
            dist = np.round((128 + 9) * u).astype(np.int64)
            back = (960 - 128 - 9 - 128) * u
        else:
            # reference quirk: no fs/FS_LTE rescale on this arm
            # (src/searcher.cpp:783)
            dist = np.round((128 + 32) * k_factor).astype(np.int64)
            back = (960 - 128 - 32 - 128) * u
        p.foe_conv[:, ci] = fs_eff / (2.0 * np.pi * dist)
        p.foe_phase[:, :, ci] = (np.pi * -freq
                                 / (FS_LTE / 16 / 2) * -dist)[:, None]
        for oi in range(2):
            first_sss = wrap(p.frame_start[:, oi] + back, -0.5,
                             9600 * 2 - 0.5)
            adj = first_sss - HALF_FRAME * k_factor > -0.5
            first_sss = np.where(adj, first_sss - HALF_FRAME * k_factor,
                                 first_sss)
            sn0 = np.where(adj, 10, 0)
            sss_step = HALF_FRAME * u
            n_sss_f = np.floor((n_cap - 127 - dist - 100 - first_sss)
                               / sss_step)
            loc_set = first_sss[:, None] + sss_step[:, None] * ii
            sss_ok = ii <= n_sss_f[:, None]
            sss_locs = np.round(loc_set).astype(np.int64)
            p.foe_sss[:, oi, ci] = np.where(
                sss_ok, sss_locs + base_v[:, None], 0)
            p.foe_pss[:, oi, ci] = np.where(
                sss_ok, sss_locs + dist[:, None] + base_v[:, None], 0)
            p.foe_mask[:, oi, ci] = sss_ok
            sn = np.where((ii.astype(np.int64) % 2) == 0, sn0[:, None],
                          10 - sn0[:, None])
            p.foe_seq[:, oi, ci] = np.where(sss_ok, sn != 0, 0)
    return p


# ----------------------------------------------------------------------
# Device program.


def _aligned_wins(cap: torch.Tensor, idx: torch.Tensor):
    """Cyclic-blend window extraction from 128-aligned rows.

    cap (n, 2); idx (...,) int window starts (out-of-range rows clamp —
    callers mask those windows). Returns (g, j, b):
      g (..., 128, 2) — lane c holds capture sample idx + (c - b) mod 128
        of rows a = idx // 128 and a + 1, b = idx % 128;
      j (..., 128) — the original in-window sample index of each lane;
      b (...,) — DFT_128(true window) = e^{2 pi i b k/128} DFT_128(g).
    """
    n = cap.shape[0]
    if n % 128:
        cap = F.pad(cap, (0, 0, 0, 128 - n % 128))
    V = cap.view(-1, 128, 2)
    idx = idx.long()
    a = torch.div(idx, 128, rounding_mode="floor")
    b = idx - a * 128
    y = V[a.clamp(0, V.shape[0] - 1)]
    y2 = V[(a + 1).clamp(0, V.shape[0] - 1)]
    c = torch.arange(128, device=cap.device)
    mask = c >= b[..., None]
    g = torch.where(mask[..., None], y, y2)
    j = (c - b[..., None] + torch.where(mask, 0, 128)).to(cap.dtype)
    return g, j, b


def _extract_psss_dev(cap, idx, foc_rate, dft62, cn62):
    """FOC + 2-sample TOC + DFT to the 62 sync bins for the windows at
    ``idx``; foc_rate broadcasts to idx's shape. Returns (..., 62, 2)."""
    g, j, b = _aligned_wins(cap, idx)
    x = cmul(g, rot_pair(foc_rate[..., None] * j))
    wr, wi = dft62
    y = torch.stack([x[..., 0] @ wr - x[..., 1] @ wi,
                     x[..., 0] @ wi + x[..., 1] @ wr], dim=-1)
    # Undo the blend's b-sample cyclic rotation in the bin domain.
    tw = (2.0 * math.pi / 128.0) * b[..., None].to(cap.dtype) * cn62
    return cmul(y, rot_pair(tw))


def _combine(h, np_, raw, mask):
    """MMSE combination across repetitions. h, raw (B, R, 62, 2);
    np_, mask (B, R). Returns (np_est (B, 62), est (B, 62, 2))."""
    w = mask / torch.where(np_ > 0, np_, 1.0)
    acc = torch.sum(cabs2(h) * w[..., None], dim=-2)
    np_est = 1.0 / (1.0 + acc)
    num = torch.sum(cmul(cconj(h), raw) * w[..., None, None], dim=-3)
    return np_est, num * np_est[..., None]


def _ml_lls(est, np12, tables):
    """Log-likelihood of the 168 hypotheses: est (B, 124, 2); np12
    (B, 124); tables (B, 168, 124) +/-1. Returns (B, 168)."""
    inv = 1.0 / np12
    s_term = torch.sum((1.0 + cabs2(est)) * inv, dim=-1)
    er, ei = est[..., 0], est[..., 1]
    cr = torch.einsum("bhk,bk->bh", tables, er)
    ci = -torch.einsum("bhk,bk->bh", tables, ei)
    cwr = torch.einsum("bhk,bk->bh", tables, er * inv)
    cwi = -torch.einsum("bhk,bk->bh", tables, ei * inv)
    mag = torch.sqrt(cr * cr + ci * ci)
    mag = torch.where(mag > 0, mag, 1.0)
    return -s_term[:, None] + 2.0 * (cwr * cr + cwi * ci) / mag


@functools.lru_cache(maxsize=4)
def _device_tables(device: torch.device):
    """The constant tables on ``device``: ((wr, wi) of _dft62, cn62,
    pss_fd_conj, smooth13^T, sss_tables)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (tuple(put(m) for m in _dft62()), put(_CN62), put(_pss_fd_conj()),
            put(_smooth13_mat()).T, put(_sss_tables()))


def _sync_device(cap: torch.Tensor, plan, thresh2_n_sigma: float,
                 non_blocking: bool = False) -> Dict[str, torch.Tensor]:
    """The batched sync program. cap (n_cap, 2) f32 on the device; plan a
    SyncPlan (or the JAX package's, which has the same fields). Returns
    (B,)-shaped n_id_1, cp_sel, ord_sel, detected, dfreq, lik_final,
    lik_mean, lik_std. ``non_blocking`` uploads the plan without waiting
    for the stream (:func:`upload`)."""
    dev = cap.device

    def put(a):
        return upload(a, dev, non_blocking)

    pss_idx, rep_mask = put(plan.pss_idx), put(plan.rep_mask)
    foc, inv_fs, n_id_2 = put(plan.foc), put(plan.inv_fs), \
        put(plan.n_id_2).long()
    foe_pss, foe_sss = put(plan.foe_pss), put(plan.foe_sss)
    foe_mask, foe_seq = put(plan.foe_mask), put(plan.foe_seq).long()
    foe_phase, foe_conv = put(plan.foe_phase), put(plan.foe_conv)
    dft62, cn62, pss_conj, sm_t, sss_tabs = _device_tables(dev)
    B = pss_idx.shape[0]
    bi = torch.arange(B, device=dev)

    def extract(idx, rate):
        return _extract_psss_dev(cap, idx, rate, dft62, cn62)

    foc_rate = 2.0 * math.pi * foc * inv_fs                 # (B,)

    # ---- detection: channel estimates from every PSS repetition.
    pconj = pss_conj[n_id_2]                               # (B, 62, 2)
    h_raw = cmul(extract(pss_idx, foc_rate[:, None]), pconj[:, None])
    h_sm = torch.stack([h_raw[..., 0] @ sm_t, h_raw[..., 1] @ sm_t], -1)
    pss_np = torch.mean(cabs2(h_sm - h_raw), dim=-1)       # (B, R)

    nrm_raw = extract(pss_idx - 128 - 9, foc_rate[:, None])
    ext_raw = extract(pss_idx - 128 - 32, foc_rate[:, None])

    # Parity split: h1 = even repetitions, h2 = odd.
    ev, od = rep_mask[:, 0::2], rep_mask[:, 1::2]
    h1, h2 = h_sm[:, 0::2], h_sm[:, 1::2]
    np1, np2 = pss_np[:, 0::2], pss_np[:, 1::2]
    np_h1, est_nrm_h1 = _combine(h1, np1, nrm_raw[:, 0::2], ev)
    np_h2, est_nrm_h2 = _combine(h2, np2, nrm_raw[:, 1::2], od)
    _, est_ext_h1 = _combine(h1, np1, ext_raw[:, 0::2], ev)
    _, est_ext_h2 = _combine(h2, np2, ext_raw[:, 1::2], od)

    np12 = torch.cat([np_h1, np_h2], dim=-1)               # (B, 124)
    est_nrm = torch.cat([est_nrm_h1, est_nrm_h2], dim=-2)
    est_ext = torch.cat([est_ext_h1, est_ext_h2], dim=-2)

    # ---- ML scan over 168 x 2 orderings x {nrm, ext}.
    tabs = sss_tabs[n_id_2]                                # (B, 168, 2, 62)
    h12 = tabs.reshape(B, 168, 124)
    h21 = torch.flip(tabs, dims=[2]).reshape(B, 168, 124)
    ll = torch.stack([
        torch.stack([_ml_lls(est_nrm, np12, h12),
                     _ml_lls(est_nrm, np12, h21)], dim=-1),
        torch.stack([_ml_lls(est_ext, np12, h12),
                     _ml_lls(est_ext, np12, h21)], dim=-1),
    ], dim=-1)                                             # (B, 168, 2o, 2c)

    cp_sel = torch.argmax(ll.amax(dim=(1, 2)), dim=-1)
    ll_cp = ll[bi, :, :, cp_sel]                           # (B, 168, 2o)
    ord_sel = torch.argmax(ll_cp.amax(dim=1), dim=-1)
    ll_ord = ll_cp[bi, :, ord_sel]                         # (B, 168)
    n_id_1 = torch.argmax(ll_ord, dim=-1)
    lik_final = ll_ord.amax(dim=-1)

    flat = ll.reshape(B, -1)                               # (B, 672)
    lik_mean = torch.mean(flat, dim=-1)
    lik_std = torch.sqrt(torch.sum((flat - lik_mean[:, None]) ** 2, dim=-1)
                         / (flat.shape[-1] - 1))
    detected = lik_final >= lik_mean + lik_std * thresh2_n_sigma

    # ---- fine FOE for all four (ordering, cp) combos, then select.
    fr = foc_rate[:, None, None, None]
    fh_raw = cmul(extract(foe_pss, fr), pconj[:, None, None, None])
    fh_sm = torch.stack([fh_raw[..., 0] @ sm_t, fh_raw[..., 1] @ sm_t], -1)
    fnp = torch.mean(cabs2(fh_sm - fh_raw), dim=-1)        # (B, 2, 2, S)

    # Known SSS of the detected (n_id_1, slot) per repetition.
    tab_det = tabs[bi, n_id_1]                             # (B, 2, 62)
    known = tab_det[bi[:, None, None, None], foe_seq]      # (B,2,2,S,62)

    prot = rot_pair(foe_phase[..., None, None])            # (B,2,2,1,1,2)
    sss_raw = cmul(extract(foe_sss, fr), prot) * known[..., None]

    fh2 = cabs2(fh_sm)
    # Zero guard: an all-zero padding window gives fh2 = fnp = 0.
    fnp_s = torch.where(fnp > 0, fnp, 1.0)
    w = fh2 / (2.0 * fh2 * fnp_s[..., None] + (fnp_s ** 2)[..., None])
    m_all = torch.sum(cmul(cconj(sss_raw), fh_raw)
                      * (w * foe_mask[..., None])[..., None],
                      dim=(-3, -2))                        # (B, 2, 2, 2)
    m_sel = m_all[bi, ord_sel, cp_sel]                     # (B, 2)
    conv = foe_conv[bi, cp_sel]
    dfreq = torch.atan2(m_sel[:, 1], m_sel[:, 0]) * conv
    return {"n_id_1": n_id_1, "cp_sel": cp_sel, "ord_sel": ord_sel,
            "detected": detected, "dfreq": dfreq, "lik_final": lik_final,
            "lik_mean": lik_mean, "lik_std": lik_std}


# ----------------------------------------------------------------------
# Host wrapper.


@dataclasses.dataclass
class SyncPending:
    """A sync program in flight: its outputs (device tensors, or a
    :class:`HostFetch` of them when deferred), its plan and its cells."""

    out: object
    plan: Optional[SyncPlan]
    cells: List[Cell]


def sss_foe_batch(cells: List[Cell], cap: torch.Tensor,
                  thresh2_n_sigma: float, n_cap: Optional[int] = None,
                  cap_bases: Optional[Sequence[int]] = None,
                  defer: bool = False):
    """SSS detection + fine FOE for every candidate peak.

    cap (n, 2) f32 re/im on the device: one capture, or with ``cap_bases``
    a stack of captures of length ``n_cap`` each (default: cap's length).
    Returns new Cell records: detected peaks carry n_id_1/cp_type/
    frame_start/freq_fine, rejected ones n_id_1 == -1 (the contract of the
    host sss_detect + pss_sss_foe). ``defer=True`` returns a
    :class:`SyncPending` whose results are on their way to the host
    (:class:`HostFetch`); :func:`finish_sync_batch` collects it.
    """
    if not cells:
        return SyncPending(None, None, []) if defer else []
    plan = sync_plan(cells, cap.shape[0] if n_cap is None else n_cap,
                     cap_bases)
    out = _sync_device(cap, plan, thresh2_n_sigma, non_blocking=defer)
    if defer:
        return SyncPending(HostFetch(out), plan, list(cells))
    return finish_sync_batch(SyncPending(out, plan, list(cells)))


def finish_sync_batch(pending: SyncPending) -> List[Cell]:
    """Fetch the results of a sync program (deferred or not) and unpack
    them into Cell records."""
    if not pending.cells:
        return []
    plan = pending.plan
    o = (pending.out.wait() if isinstance(pending.out, HostFetch)
         else {k: to_host(v) for k, v in pending.out.items()})
    res: List[Cell] = []
    for b, cell in enumerate(pending.cells):
        c = dataclasses.replace(cell)
        if o["detected"][b]:
            c.n_id_1 = int(o["n_id_1"][b])
            c.cp_type = "extended" if o["cp_sel"][b] else "normal"
            c.frame_start = float(plan.frame_start[b, int(o["ord_sel"][b])])
            c.freq_fine = cell.freq + float(o["dfreq"][b])
        res.append(c)
    return res
