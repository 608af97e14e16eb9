"""Batched TFG extraction + TFOEC + channel estimation + blind MIB decode
on the device.

Counterpart of lte_cell_scanner_tpu/ops/mib_jax.py (reference:
src/searcher.cpp:852-1692, extract_tfg / tfoec / chan_est / pbch_extract /
decode_mib). One program runs every surviving candidate of a capture:

- the symbol windows of the COMPACT consumed-row grid (the RS rows, the
  sym-1 rows and the 7 x 4 PBCH rows: 394 of the 854 normal-CP rows) are
  demodulated by the ``fd_demod`` CUDA kernel (ops/fd_demod.py);
- superfine FOE/TOE and the grid compensations are batched RS gathers;
- channel estimation is either the reference's enabled hex (Delaunay)
  interpolator, as six constant per-comb-shift linear maps
  (:func:`_hex_interp_tabs`), or the separable freq-then-time one;
- the 4 frame timings x {1, 2, 4} ports of the blind MIB search run at
  once: SFBC, QPSK LLRs, descrambling and deratematching are tensor math,
  the tail-biting Viterbi is the ``viterbi`` CUDA kernel
  (models/viterbi.py), and the CRC16 check is a GF(2) product.

:func:`extract_tfg_batch` runs the same plan's windows at EVERY row of
the grid (854 normal-CP rows, 732 extended) through the same kernel, for
consumers beyond the MIB chain.

Float64 sample-index arithmetic (symbol timestamps, absolute FOC phases)
stays on the host in :func:`mib_plan`, which quantizes the phases to
2*pi/65536 and the lateness to 2^-15 samples exactly as the JAX planner
does, so both programs decode the same values. Per-cell tables are picked
by indexing. Complex values are (..., 2) float32 planes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lte_cell_scanner_tpu_torch.constants import FS_LTE, N_RB_MAXDL
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.models.crc import lte_calc_crc
from lte_cell_scanner_tpu_torch.models.pn import lte_pn_batch
from lte_cell_scanner_tpu_torch.models.ratematch import _index_map
from lte_cell_scanner_tpu_torch.models.rs import rs_dl_shift
from lte_cell_scanner_tpu_torch.models.viterbi import viterbi_tl
from lte_cell_scanner_tpu_torch.ops.chanest import _hex_extend, _hex_pair_map
from lte_cell_scanner_tpu_torch.ops.fd_demod import MIB_DFT, fd_demod
from lte_cell_scanner_tpu_torch.ops.pbch import N_RB_DL_TABLE, PHICH_RES_TABLE
from lte_cell_scanner_tpu_torch.ops.sync_torch import (cabs2, cconj, cmul,
                                                       rot_pair)
from lte_cell_scanner_tpu_torch.ops.tfg import CN, symbol_timestamps_batch
from lte_cell_scanner_tpu_torch.utils.device import (HostFetch, to_host,
                                                     upload)
from lte_cell_scanner_tpu_torch.utils.dsp import interp1

_PORT_CFGS = (1, 2, 4)
MIB_STAGES = ("tfg", "tfoec", "toe", "chanest", "pbch", "llr", "vit")


# ----------------------------------------------------------------------
# Constant tables (host side, cached per CP geometry).


@functools.lru_cache(maxsize=1)
def _freq_interp_mats():
    """(6, 72, 12) linear-interpolation matrices: RS comb at shift s ->
    all 72 subcarriers."""
    out = np.zeros((6, 72, 12), np.float64)
    xq = np.arange(72, dtype=np.float64)
    for s in range(6):
        X = np.arange(s, 72, 6, dtype=np.float64)
        for i in range(12):
            basis = np.zeros(12)
            basis[i] = 1.0
            out[s, :, i] = interp1(X, basis, xq)
    return out.astype(np.float32)


def _rs_rows(n_symb_dl: int, n_ofdm: int):
    """RS row indices: (rows01 (2, n_slot) for sym {0, n_symb_dl-3},
    rows23 (n_slot,) for sym 1)."""
    slots = np.arange(n_ofdm // n_symb_dl)
    rows01 = np.stack([slots * n_symb_dl,
                       slots * n_symb_dl + n_symb_dl - 3])
    return rows01.astype(np.int32), (slots * n_symb_dl + 1).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _time_interp_mat(n_symb_dl: int, n_ofdm: int, port_class: int):
    """(n_ofdm, n_rs) time-interpolation matrix over the RS row grid
    (port_class 0: ports 0/1 interleaved {0, n-3}; 1: ports 2/3)."""
    rows01, rows23 = _rs_rows(n_symb_dl, n_ofdm)
    if port_class == 0:
        rs_set = np.sort(rows01.reshape(-1)).astype(np.float64)
    else:
        rs_set = rows23.astype(np.float64)
    n_rs = len(rs_set)
    tq = np.arange(n_ofdm, dtype=np.float64)
    m = np.zeros((n_ofdm, n_rs), np.float64)
    for i in range(n_rs):
        basis = np.zeros(n_rs)
        basis[i] = 1.0
        m[:, i] = interp1(rs_set, basis, tq)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hex_interp_tabs(n_symb_dl: int, n_ofdm: int, rows_sel: tuple,
                     port_class: int):
    """Tables of the hex (Delaunay) interpolator at the ``rows_sel`` rows.

    Each strip between adjacent RS rows is a fixed linear map of the two
    rows' 2x12 filtered estimates (ops/chanest.py), and the lattice is set
    by the first RS row's comb shift m (the second row's is (m + 3) % 6),
    so the interpolation is SIX constant (n_sel, 72, 24) maps:

        out[b, j] = tabs[m_b, j] @ concat(ce_filt[b, pair_idx[j]],
                                          ce_filt[b, pair_idx[j] + 1])

    Returns (tabs (6, n_sel, 72, 24) float64, pair_idx (n_sel,) int32).
    """
    n_slot = n_ofdm // n_symb_dl
    rows0 = np.arange(n_slot) * n_symb_dl
    if port_class == 0:
        rs_set = np.sort(np.concatenate([rows0, rows0 + n_symb_dl - 3]))
    else:
        rs_set = rows0 + 1
    n_sel = len(rows_sel)
    tabs = np.zeros((6, n_sel, 72, 24), np.float64)
    pair_idx = np.zeros(n_sel, np.int32)
    xq = np.arange(72, dtype=np.float64)
    for m in range(6):
        shift = (m, (m + 3) % 6)
        # Rows at/before the first RS row use its 1-D hex-extended
        # interpolation.
        top0 = np.zeros((72, 12))
        for i in range(12):
            basis = np.zeros(12)
            basis[i] = 1.0
            xs, vs = _hex_extend(
                np.arange(shift[0], 72, 6, dtype=np.float64), basis)
            top0[:, i] = interp1(xs, vs, xq)
        for j, r in enumerate(rows_sel):
            if r <= rs_set[0]:
                pair_idx[j] = 0
                tabs[m, j, :, :12] = top0
                continue
            if r > rs_set[-1]:
                # Rows past the last RS row copy it (filled from the LAST
                # strip's bottom edge).
                t = len(rs_set) - 2
                r_eff = int(rs_set[-1])
            else:
                # rs_set[t] < r <= rs_set[t + 1]  ->  strip t.
                t = int(np.searchsorted(rs_set, r)) - 1
                r_eff = int(r)
            top_shift = shift[1] if (t & 1) else shift[0]
            bot_shift = shift[0] if (t & 1) else shift[1]
            spacing = int(rs_set[t + 1] - rs_set[t])
            w = _hex_pair_map(top_shift, bot_shift, spacing)
            off = r_eff - int(rs_set[t]) - 1
            pair_idx[j] = t
            tabs[m, j] = w[off * 72:(off + 1) * 72]
    return tabs, pair_idx


@functools.lru_cache(maxsize=1)
def _filter_mats12():
    """Averaging matrices of the 7-point staggered-comb CE filter:
    same-row 3-tap + adjacent-row 2-tap (lo: {k-1,k}; hi: {k,k+1}), with
    per-subcarrier tap counts."""
    curr = np.zeros((12, 12), np.float32)
    lo = np.zeros((12, 12), np.float32)
    hi = np.zeros((12, 12), np.float32)
    n_curr = np.zeros(12, np.float32)
    n_lo = np.zeros(12, np.float32)
    n_hi = np.zeros(12, np.float32)
    for k in range(12):
        for i in (k - 1, k, k + 1):
            if 0 <= i < 12:
                curr[k, i] = 1
                n_curr[k] += 1
        for i in (k - 1, k):
            if 0 <= i < 12:
                lo[k, i] = 1
                n_lo[k] += 1
        for i in (k, k + 1):
            if 0 <= i < 12:
                hi[k, i] = 1
                n_hi[k] += 1
    return curr, lo, hi, n_curr, n_lo, n_hi


@functools.lru_cache(maxsize=2)
def _deratematch_mat(m_bit: int):
    """(120, m_bit) averaging matrix inverting rate matching on LLRs."""
    idx = _index_map(40, m_bit)                       # (m_bit, 2)
    flat = idx[:, 0] * 40 + idx[:, 1]
    count = np.bincount(flat, minlength=120).astype(np.float64)
    w = np.zeros((120, m_bit), np.float64)
    w[flat, np.arange(m_bit)] = 1.0 / count[flat]
    return w.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _crc16_mat():
    """(24, 16) GF(2) generator matrix of the zero-seeded CRC16."""
    m = np.zeros((24, 16), np.int32)
    for i in range(24):
        basis = np.zeros(24, np.uint8)
        basis[i] = 1
        m[i] = lte_calc_crc(basis, "crc16")
    return m


@functools.lru_cache(maxsize=4)
def _pbch_rows_cols(n_symb_dl: int, v_shift_m3: int):
    """PBCH RE gather indices for frame-timing guess 0
    (reference: src/searcher.cpp:1482-1522)."""
    sc = np.arange(72)
    rows, cols = [], []
    for fr in range(4):
        for sym in range(4):
            rs_here = (sym in (0, 1)) or (sym == 3 and n_symb_dl == 6)
            mask = ~((sc % 3 == v_shift_m3) & rs_here)
            sym_num = fr * 10 * 2 * n_symb_dl + n_symb_dl + sym
            rows.append(np.full(mask.sum(), sym_num))
            cols.append(sc[mask])
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(cols).astype(np.int32))


@functools.lru_cache(maxsize=2)
def _pbch_sel(n_symb_dl: int):
    """(3, n_frame, 4*72) f32 RE-compaction matrices, one per v_shift:
    row n of variant v selects the n-th kept PBCH RE of one frame's four
    PBCH symbols (flattened sym*72+sc), in the reference's order."""
    stride = 10 * 2 * n_symb_dl
    out = []
    for v in range(3):
        rows, cols = _pbch_rows_cols(n_symb_dl, v)
        n_frame = len(rows) // 4
        m = np.zeros((n_frame, 4 * 72), np.float32)
        for i, (r, c) in enumerate(zip(rows, cols)):
            f = r // stride
            assert i // n_frame == f, "PBCH REs not frame-major"
            sym = r - f * stride - n_symb_dl
            m[i % n_frame, sym * 72 + c] = 1.0
        out.append(m)
    return np.stack(out)


@functools.lru_cache(maxsize=2)
def _all_cell_tables(cp_type: str):
    """All 504 cells' constant tables: (rs_sign (504, 20, 3, 12, 2) i8 —
    signs of conj(RS) at 6 RB for slots 0..19 and syms {0, 1, n-3} —,
    shifts (504, 4, 2) i32 comb shifts, scr_sign (504, m_bit) i8 — the
    PBCH scrambler as +-1)."""
    n_symb_dl = 7 if cp_type == "normal" else 6
    n_cp = 1 if cp_type == "normal" else 0
    m_bit = 1920 if cp_type == "normal" else 1728
    nid = np.arange(504)[:, None, None]
    slot = np.arange(20)[None, :, None]
    sym = np.array([0, 1, n_symb_dl - 3])[None, None, :]
    c_init = ((1 << 10) * (7 * (slot + 1) + sym + 1) * (2 * nid + 1)
              + 2 * nid + n_cp)
    # RS element m is built from PN bits 2m, 2m+1; the 6-RB RS is
    # m = N_RB_MAXDL-6 .. N_RB_MAXDL+5.
    lo = 2 * (N_RB_MAXDL - 6)
    c = lte_pn_batch(c_init.reshape(-1).astype(np.uint64),
                     lo + 24).astype(np.int8)
    c = c[:, lo:].reshape(504, 20, 3, 12, 2)
    rs = np.stack([1 - 2 * c[..., 0], 2 * c[..., 1] - 1], -1).astype(np.int8)
    sh = np.zeros((504, 4, 2), np.int32)
    for n in range(504):
        for port in (0, 1):
            sh[n, port] = [rs_dl_shift(0, 0, port, cp_type, n),
                           rs_dl_shift(0, n_symb_dl - 3, port, cp_type, n)]
        for port in (2, 3):
            sh[n, port] = [rs_dl_shift(0, 1, port, cp_type, n),
                           rs_dl_shift(1, 1, port, cp_type, n)]
    scr = (1 - 2 * lte_pn_batch(np.arange(504, dtype=np.uint64), m_bit)
           .astype(np.int8)).astype(np.int8)
    return rs, sh, scr


@functools.lru_cache(maxsize=1)
def _crc_masks():
    """(3, 16) CRC xor masks per port config (1/2/4 antennas)."""
    m = np.zeros((3, 16), np.int32)
    m[1] = 1                      # 2 ports: all-ones mask
    m[2, 1::2] = 1                # 4 ports: alternating
    return m


# ----------------------------------------------------------------------
# Host-side plan.


@dataclasses.dataclass
class MibPlan:
    """Arrays for one CP type (leading axis B = candidates); the field
    names and arrays of the JAX package's MibPlan.

    The f64 symbol timestamps are the first integer start plus u8
    symbol-to-symbol deltas (lossless, 136..161 samples) and an i16
    fixed-point fractional lateness (2^-15 sample); the per-start FOC
    phase is i16 turns (2*pi/65536). The quantization changes values, so
    it is kept for parity with the JAX program.
    """

    n_symb_dl: int
    n_ofdm: int
    m_bit: int
    start0: np.ndarray        # (B,) i32 — first symbol start
    sdelta: np.ndarray        # (B, n_ofdm) u8 — start deltas, [0] == 0
    phase0_q: np.ndarray      # (B, n_ofdm) i16 — FOC phase / 2pi * 2^16
    inwin: np.ndarray         # (B,) f32 — FOC phase rate per sample
    late_q: np.ndarray        # (B, n_ofdm) i16 — (start - ts) * 2^15
    base: np.ndarray          # (B,) i32 — the cell's capture offset in
                              # a stack of captures (0 for one capture)
    n_id: np.ndarray          # (B,) i32 — n_id_cell
    omk_base: np.ndarray      # (B,) f32 — (fc_prog - fc_req)/fc_prog
    inv_fcp: np.ndarray       # (B,) f32 — 1/fc_programmed
    ok: np.ndarray            # (B,) bool — the grid fits in the capture
    cells: list               # the Cell records


def mib_plan(cells: Sequence[Cell], n_cap: int,
             cap_bases: Optional[Sequence[int]] = None) -> MibPlan:
    """Float64 symbol-timestamp plan for a batch of same-CP cells; fc/fs
    are taken per cell.

    ``n_cap`` is the length of ONE capture: a cell whose grid does not fit
    in it fails (``ok``). ``cap_bases`` (per cell) offsets every symbol
    start into a stack of captures of that length laid end to end.
    """
    cp_type = cells[0].cp_type
    if any(c.cp_type != cp_type for c in cells):
        raise ValueError("mib_plan: cells must share one CP type")
    n_symb_dl = 7 if cp_type == "normal" else 6
    n_ofdm = 6 * 10 * 2 * n_symb_dl + 2 * n_symb_dl
    m_bit = 1920 if cp_type == "normal" else 1728
    n = len(cells)
    p = MibPlan(
        n_symb_dl=n_symb_dl, n_ofdm=n_ofdm, m_bit=m_bit,
        start0=np.zeros(n, np.int32),
        sdelta=np.zeros((n, n_ofdm), np.uint8),
        phase0_q=np.zeros((n, n_ofdm), np.int16),
        inwin=np.zeros(n, np.float32),
        late_q=np.zeros((n, n_ofdm), np.int16),
        base=np.zeros(n, np.int32),
        n_id=np.zeros(n, np.int32),
        omk_base=np.zeros(n, np.float32),
        inv_fcp=np.zeros(n, np.float32),
        ok=np.zeros(n, bool),
        cells=list(cells),
    )
    fc_req = np.array([c.fc_requested for c in cells], np.float64)
    fc_prog = np.array([c.fc_programmed for c in cells], np.float64)
    fs_prog = np.array([c.fs_programmed for c in cells], np.float64)
    freq_fine = np.array([c.freq_fine for c in cells], np.float64)
    frame_st = np.array([c.frame_start for c in cells], np.float64)
    base_v = (np.zeros(n, np.int64) if cap_bases is None
              else np.asarray(list(cap_bases)[:n], np.int64))

    k_factor = (fc_req - freq_fine) / fc_prog
    ts = symbol_timestamps_batch(cp_type, frame_st, fs_prog, k_factor)
    starts = np.round(ts).astype(np.int64)
    ok = (starts[:, -1] + 128 <= n_cap) & (starts[:, 0] >= 0)
    # Rows that do not fit keep all-zero plans (the cell fails MIB).
    okf = ok[:, None]
    p.ok[:] = ok
    p.start0[:] = np.where(ok, starts[:, 0] + base_v, 0)
    deltas = np.diff(starts, axis=1)          # 136..161 per CP geometry
    if deltas[ok].size and (deltas[ok].min() <= 0 or deltas[ok].max() > 255):
        raise ValueError("mib_plan: symbol start deltas out of u8 range")
    p.sdelta[:, 1:] = np.where(okf, deltas, 0)
    p.base[:] = np.where(ok, base_v, 0)
    late_q = np.round((starts - ts) * 32768.0)           # |late| <= 0.5
    p.late_q[:] = np.where(okf, late_q, 0)
    fs_eff = fs_prog * k_factor
    phase_turns = np.mod(-freq_fine[:, None] * starts / fs_eff[:, None], 1.0)
    q = np.round(phase_turns * 65536.0)
    p.phase0_q[:] = np.where(okf, (q + 32768) % 65536 - 32768, 0)
    p.inwin[:] = np.where(ok, -2.0 * np.pi * freq_fine / fs_eff, 0.0)
    p.omk_base[:] = np.where(ok, (fc_prog - fc_req) / fc_prog, 0.0)
    p.inv_fcp[:] = np.where(ok, 1.0 / fc_prog, 0.0)
    p.n_id[:] = [c.n_id_cell() for c in cells]
    return p


# ----------------------------------------------------------------------
# Device program.


@dataclasses.dataclass
class _Consts:
    """Device-resident constants of one CP geometry and interpolator."""

    cn: torch.Tensor          # (72,) subcarrier index
    wd_k: torch.Tensor        # (120, m_bit) deratematch, time-major rows
    crc_m: torch.Tensor       # (24, 16) f32
    crc_masks: torch.Tensor   # (3, 16) i64
    idx_c: torch.Tensor       # compact row indices into the full grid
    pbch_cols: torch.Tensor   # (3, n_frame) kept column per v_shift
    filt: tuple               # _filter_mats12 on the device
    fmats: torch.Tensor       # (6, 72, 12)
    tmats: tuple              # ((t01_e, t01_o), (t23_e, t23_o))
    hex: tuple                # ((tabs01, pidx01), (tabs23, pidx23))
    rs_tab: torch.Tensor      # (504, 20, 3, 12, 2) i8
    shifts_tab: torch.Tensor  # (504, 4, 2) i64
    scr_tab: torch.Tensor     # (504, m_bit) i8
    n_frame: int


def _rows_sel(n_symb_dl: int):
    """The 7 frames x 4 PBCH symbol rows the 4 frame-timing guesses read
    (guess g reads frames g..g+3)."""
    stride = 10 * 2 * n_symb_dl
    return tuple(f * stride + n_symb_dl + s for f in range(7)
                 for s in range(4))


@functools.lru_cache(maxsize=8)
def _consts(n_symb_dl: int, n_ofdm: int, m_bit: int, interp: str,
            device: torch.device) -> _Consts:
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cp_type = "normal" if n_symb_dl == 7 else "extended"
    n_slot = n_ofdm // n_symb_dl
    rows_sel = _rows_sel(n_symb_dl)
    # Compact row layout [sym0 | sym n-3 | sym1 | pbch]: every consumer
    # is a static slice.
    rows0 = np.arange(n_slot) * n_symb_dl
    rows_used = np.concatenate([rows0, rows0 + n_symb_dl - 3, rows0 + 1,
                                np.asarray(rows_sel)])
    # Deratematch rows permuted so its product lands in the Viterbi
    # kernel's time-major layout: row chunk*12 + ti*3 + code.
    wd = _deratematch_mat(m_bit)
    perm = np.empty(120, np.int64)
    for r in range(120):
        chunk, pos = divmod(r, 12)
        ti, code = divmod(pos, 3)
        perm[r] = code * 40 + (chunk * 4 + ti)
    sel = _pbch_sel(n_symb_dl)                           # (3, nf, 288)
    t01 = _time_interp_mat(n_symb_dl, n_ofdm, 0)[np.asarray(rows_sel)]
    t23 = _time_interp_mat(n_symb_dl, n_ofdm, 1)[np.asarray(rows_sel)]
    hexes = []
    if interp == "hex":
        for pc in (0, 1):
            tabs, pidx = _hex_interp_tabs(n_symb_dl, n_ofdm, rows_sel, pc)
            hexes.append((put(tabs.astype(np.float32)), put(pidx).long()))
    rs, sh, scr = _all_cell_tables(cp_type)
    return _Consts(
        cn=put(CN.astype(np.float32)),
        wd_k=put(wd[perm]), crc_m=put(_crc16_mat().astype(np.float32)),
        crc_masks=put(_crc_masks()).long(), idx_c=put(rows_used).long(),
        pbch_cols=put(np.argmax(sel, axis=2)).long(),
        filt=tuple(put(a) for a in _filter_mats12()),
        fmats=put(_freq_interp_mats()),
        tmats=((put(t01[:, 0::2]), put(t01[:, 1::2])),
               (put(t23[:, 0::2]), put(t23[:, 1::2]))),
        hex=tuple(hexes), rs_tab=put(rs), shifts_tab=put(sh).long(),
        scr_tab=put(scr), n_frame=sel.shape[1])


def _sel6(x, shift):
    """Pick comb offset ``shift`` (B,) from x (B, R, 12, 6, 2) ->
    (B, R, 12, 2)."""
    B, R = x.shape[:2]
    idx = shift.view(B, 1, 1, 1, 1).expand(B, R, 12, 1, 2)
    return torch.gather(x, 3, idx)[:, :, :, 0]


def _rs_tile(rs_conj, sym_class, n_slot):
    """rs_conj (B, 20, 3, 12, 2) -> the slot-mod-20 sequence
    (B, n_slot, 12, 2)."""
    r = rs_conj[:, :, sym_class]
    reps = (n_slot + 19) // 20
    return r.repeat(1, reps, 1, 1)[:, :n_slot]


def _chan_est_dev(blk0, blk1, blk2, rs_conj, shifts, n_symb_dl, n_ofdm,
                  k: _Consts, interp: str):
    """Batched 4-port channel estimation at the 28 PBCH rows only.

    blk0/blk1/blk2 (B, n_slot, 72, 2): the compact grid's RS row blocks
    (per-slot sym 0, sym n_symb_dl-3, sym 1). Returns
    (ce (B, 4, 28, 72, 2), np_v (B, 4))."""
    B = blk0.shape[0]
    dt = blk0.dtype
    n_slot = n_ofdm // n_symb_dl
    curr, lo, hi, n_curr, n_lo, n_hi = k.filt

    def rowmat(x, m):
        return torch.stack([x[..., 0] @ m.T, x[..., 1] @ m.T], -1)

    def filter_rows(ce_raw, parity_lower):
        """ce_raw (B, R, 12, 2); parity_lower (B, R) 1.0 where the row's
        adjacent-row taps are {k-1, k}."""
        prev = F.pad(ce_raw[:, :-1], (0, 0, 0, 0, 1, 0))
        nxt = F.pad(ce_raw[:, 1:], (0, 0, 0, 0, 0, 1))
        adj = prev + nxt
        r = ce_raw.shape[1]
        ar = torch.arange(r, device=ce_raw.device)
        n_adj = (ar > 0).to(dt) + (ar < r - 1).to(dt)
        pl = parity_lower[..., None, None]
        tot = rowmat(ce_raw, curr) + torch.where(
            pl > 0, rowmat(adj, lo), rowmat(adj, hi))
        cnt = n_curr[None, None] + n_adj[None, :, None] * torch.where(
            parity_lower[..., None] > 0, n_lo[None, None], n_hi[None, None])
        return tot / cnt[..., None]

    ce_out, np_out = [], []
    for port in range(4):
        if port <= 1:
            # RS rows interleave sym 0 (shift idx 0) and sym n-3 (idx 1).
            raw_a = cmul(_sel6(blk0.reshape(B, n_slot, 12, 6, 2),
                               shifts[:, port, 0]),
                         _rs_tile(rs_conj, 0, n_slot))
            raw_b = cmul(_sel6(blk1.reshape(B, n_slot, 12, 6, 2),
                               shifts[:, port, 1]),
                         _rs_tile(rs_conj, 2, n_slot))
            ce_raw = torch.stack([raw_a, raw_b], dim=2).reshape(
                B, 2 * n_slot, 12, 2)
            par = torch.arange(2 * n_slot, device=blk0.device) % 2
        else:
            # sym-1 rows; the shift alternates with slot parity.
            sym1 = blk2.reshape(B, n_slot, 12, 6, 2)
            v_e = _sel6(sym1, shifts[:, port, 0])
            v_o = _sel6(sym1, shifts[:, port, 1])
            par = torch.arange(n_slot, device=blk0.device) % 2
            vals = torch.where((par == 0)[None, :, None, None], v_e, v_o)
            ce_raw = cmul(vals, _rs_tile(rs_conj, 1, n_slot))

        low0 = shifts[:, port, 0] < shifts[:, port, 1]
        parity_lower = torch.where(par[None, :] == 0, low0[:, None],
                                   ~low0[:, None]).to(dt)
        ce_filt = filter_rows(ce_raw, parity_lower)
        np_est = torch.mean(cabs2(ce_filt - ce_raw), dim=(1, 2))

        if interp == "hex":
            # Each consumed row is one 72x24 map of the two RS rows around
            # it, picked by the cell's first comb shift.
            tabs, pidx = k.hex[0 if port <= 1 else 1]
            r = ce_filt.shape[1]
            vp = torch.cat([ce_filt[:, pidx],
                            ce_filt[:, torch.clamp(pidx + 1, max=r - 1)]],
                           dim=2)                        # (B, n_sel, 24, 2)
            ce_tfg = torch.einsum("bjki,bjip->bjkp", tabs[shifts[:, port, 0]],
                                  vp)
        else:
            # Frequency then time interpolation, per parity group.
            m_e = k.fmats[shifts[:, port, 0]]
            m_o = k.fmats[shifts[:, port, 1]]
            f_e = torch.einsum("bki,brip->brkp", m_e, ce_filt[:, 0::2])
            f_o = torch.einsum("bki,brip->brkp", m_o, ce_filt[:, 1::2])
            te, to = k.tmats[0 if port <= 1 else 1]
            ce_tfg = torch.einsum("tr,brkp->btkp", te, f_e) + \
                torch.einsum("tr,brkp->btkp", to, f_o)
        ce_out.append(ce_tfg)
        np_out.append(np_est)
    return torch.stack(ce_out, dim=1), torch.stack(np_out, dim=1)


def _sfbc_dev(pbch_sym, pbch_ce, np_v):
    """All three port configs at once: pbch_sym (B, G, n, 2); pbch_ce
    (B, 4, G, n, 2); np_v (B, 4). Returns (syms (B, G, 3, n, 2),
    np_out (B, G, 3, n))."""
    B, G, n, _ = pbch_sym.shape
    sqrt2 = float(np.sqrt(2.0).astype(np.float32))
    # ---- 1 port: MRC.
    h = pbch_ce.transpose(1, 2)                          # (B, G, 4, n, 2)
    h0 = h[:, :, 0]
    gain = cconj(h0) / cabs2(h0)[..., None]
    s1p = cmul(pbch_sym, gain)
    np1p = np_v[:, 0][:, None, None] * cabs2(gain)

    # ---- 2/4 ports: Alamouti pairs.
    x1 = pbch_sym[:, :, 0::2]
    x2 = pbch_sym[:, :, 1::2]
    havg = 0.5 * (h[:, :, :, 0::2] + h[:, :, :, 1::2])   # (B, G, 4, n/2, 2)
    pairs = n // 2
    use_a = ((torch.arange(pairs, device=pbch_sym.device) % 2) == 0
             )[None, None, :, None]

    def alamouti(h1, h2, np_pair):
        scale = cabs2(h1) + cabs2(h2)
        s1 = (cmul(cconj(h1), x1) + cmul(h2, cconj(x2))) / scale[..., None]
        s2 = cconj((cmul(cconj(h2), -x1) + cmul(h1, cconj(x2)))
                   / scale[..., None])
        np_o = (cabs2(h1) / scale ** 2 + cabs2(h2) / scale ** 2) * np_pair
        syms = torch.stack([s1, s2], dim=3).reshape(B, G, n, 2) * sqrt2
        return syms, torch.repeat_interleave(np_o, 2, dim=-1)

    np2 = torch.mean(np_v[:, :2], dim=1)[:, None, None]
    s2p, np2p = alamouti(havg[:, :, 0], havg[:, :, 1],
                         np2.expand(B, G, pairs))
    h1_4 = torch.where(use_a, havg[:, :, 0], havg[:, :, 1])
    h2_4 = torch.where(use_a, havg[:, :, 2], havg[:, :, 3])
    np4 = torch.where(use_a[..., 0],
                      0.5 * (np_v[:, 0] + np_v[:, 2])[:, None, None],
                      0.5 * (np_v[:, 1] + np_v[:, 3])[:, None, None])
    s4p, np4p = alamouti(h1_4, h2_4, np4)
    return (torch.stack([s1p, s2p, s4p], dim=2),
            torch.stack([np1p, np2p, np4p], dim=2))


def _unpack_plan(plan, rows: torch.Tensor, dev, non_blocking=False):
    """The plan's symbol starts, FOC phases, lateness and timestamps at
    the grid rows ``rows`` (the compact rows, or all of them), as the
    device works with them: (starts (B, S) i64, phase0 (B, S) f32, late
    (B, S) f32, ts (B, S) f32, n_id (B,) i64)."""
    def put(a):
        return upload(a, dev, non_blocking)

    start0 = put(plan.start0).long()
    sdelta = put(plan.sdelta).long()
    base = put(plan.base).long()
    starts = (start0[:, None] + torch.cumsum(sdelta, dim=1))[:, rows]
    phase0 = put(plan.phase0_q)[:, rows].to(torch.float32) * float(
        np.float32(2.0 * np.pi / 65536.0))
    late = put(plan.late_q)[:, rows].to(torch.float32) * float(
        np.float32(1.0 / 32768.0))
    # (starts - base) is a position within one capture (< n_cap < 2^24)
    # for a stack of any size, so the rebuilt f32 timestamps carry the
    # quantized lateness exactly.
    ts = (starts - base[:, None]).to(torch.float32) - late
    return starts, phase0, late, ts, put(plan.n_id).long()


def _demod_args(starts, inwin, phase0, late):
    """The fd_demod arguments after the capture, one window per compact
    row: (idx, foc, bpo, late, the DFT :data:`MIB_DFT`)."""
    B, S = starts.shape
    return (starts.reshape(-1).to(torch.int32),
            inwin[:, None].expand(B, S).reshape(-1).contiguous(),
            phase0.reshape(-1).contiguous(), late.reshape(-1).contiguous(),
            MIB_DFT)


def fd_demod_inputs(plan, device, full_grid: bool = False) -> tuple:
    """The fd_demod arguments (after the capture) that :func:`run` gives
    the kernel for ``plan`` (with ``full_grid``, those of
    :func:`extract_tfg_batch`: every row of the grid) — also for
    measuring the kernel alone."""
    dev = torch.device(device)
    if full_grid:
        rows = torch.arange(plan.n_ofdm, device=dev)
    else:
        rows = _consts(plan.n_symb_dl, plan.n_ofdm, plan.m_bit, "hex",
                       dev).idx_c
    starts, phase0, late, _, _ = _unpack_plan(plan, rows, dev)
    return _demod_args(starts, upload(plan.inwin, dev), phase0, late)


def run(cap: torch.Tensor, plan, interp: str = "hex",
        stages: Optional[Dict[str, object]] = None,
        non_blocking: bool = False) -> Dict[str, torch.Tensor]:
    """The MIB program for one CP type.

    cap (n_cap, 2) f32 on the device; plan a MibPlan (or the JAX
    package's, which has the same fields); interp "hex" or "freq_time".
    Returns residual_f (B,), ok (B, 4 guesses, 3 port configs) and bits
    (B, 4, 3, 40). A ``stages`` dict receives the intermediate arrays at
    the milestones of :data:`MIB_STAGES` (debugging and the parity tests).
    ``non_blocking`` uploads the plan without waiting for the stream.
    """
    dev = cap.device
    n_symb_dl, n_ofdm, m_bit = plan.n_symb_dl, plan.n_ofdm, plan.m_bit
    k = _consts(n_symb_dl, n_ofdm, m_bit,
                "hex" if interp == "hex" else "freq_time", dev)
    n_slot = n_ofdm // n_symb_dl
    o1, o2, o3 = n_slot, 2 * n_slot, 3 * n_slot

    def keep(name, *vals):
        if stages is not None:
            stages[name] = vals[0] if len(vals) == 1 else vals

    starts, phase0, late, ts, n_id = _unpack_plan(plan, k.idx_c, dev,
                                                  non_blocking)
    inwin, omk_base, inv_fcp = (upload(a, dev, non_blocking) for a in (
        plan.inwin, plan.omk_base, plan.inv_fcp))
    B, S = starts.shape

    rs_conj = k.rs_tab[n_id].to(torch.float32) * float(
        np.float32(np.sqrt(0.5)))                        # (B, 20, 3, 12, 2)
    scr_sign = k.scr_tab[n_id].to(torch.float32)         # (B, m_bit)
    shifts = k.shifts_tab[n_id]                          # (B, 4, 2)
    lower_first = (shifts[:, 0, 0] < shifts[:, 0, 1]).to(torch.float32)

    # ---- extract_tfg: the fd_demod kernel.
    tfg = fd_demod(cap, *_demod_args(starts, inwin, phase0, late)
                   ).view(B, S, 72, 2)
    keep("tfg", tfg)

    def rs_comp_rows(grid, sym_class, class_idx, shift):
        """One RS sym class of the compact grid, comb-extracted and
        RS-compensated: (B, n_slot, 12, 2)."""
        off = 0 if class_idx == 0 else o1
        rows = grid[:, off:off + n_slot].reshape(B, n_slot, 12, 6, 2)
        return cmul(_sel6(rows, shift), _rs_tile(rs_conj, sym_class, n_slot))

    # ---- tfoec: superfine FOE on the raw grid.
    foe = 0.0
    for class_idx, sym_class in ((0, 0), (1, 2)):
        rc = rs_comp_rows(tfg, sym_class, class_idx, shifts[:, 0, class_idx])
        foe = foe + torch.sum(cmul(cconj(rc[:, :-1]), rc[:, 1:]),
                              dim=(1, 2))               # (B, 2)
    residual_f = torch.atan2(foe[:, 1], foe[:, 0]) / (2.0 * math.pi) / 0.0005

    # ---- FOC: bulk rotation + timestamp rescale.
    omk = omk_base + residual_f * inv_fcp                # 1 - k_residual
    late2 = ts * omk[:, None]
    ts_comp = ts - late2
    rot = rot_pair(-2.0 * math.pi * residual_f[:, None] * ts_comp
                   / float(np.float32(FS_LTE / 16)))
    tfg_c = cmul(tfg, rot[:, :, None, :])
    tfg_c = cmul(tfg_c, rot_pair(-2.0 * math.pi * late2[..., None]
                                 * k.cn / 128.0))
    keep("tfoec", tfg_c)

    # ---- TOE on the compensated grid.
    rc0 = rs_comp_rows(tfg_c, 0, 0, shifts[:, 0, 0])
    rc1 = rs_comp_rows(tfg_c, 2, 1, shifts[:, 0, 1])
    rows_i = torch.stack([rc0, rc1], dim=2).reshape(B, 2 * n_slot, 12, 2)
    a = rows_i[:, :-1]
    b = rows_i[:, 1:]
    par = (torch.arange(2 * n_slot - 1, device=dev) % 2)[None, :, None, None]
    lf = lower_first[:, None, None, None]
    cond = torch.where(par == 0, lf, 1.0 - lf)
    r1 = torch.where(cond > 0, a, b)
    r2 = torch.where(cond > 0, b, a)
    toe = torch.sum(cmul(cconj(r1), r2), dim=(1, 2))
    toe = toe + torch.sum(cmul(cconj(r2[:, :, 0:11]), r1[:, :, 1:12]),
                          dim=(1, 2))
    delay = -torch.atan2(toe[:, 1], toe[:, 0]) / 3.0 / (2.0 * math.pi / 128.0)

    # ---- TOC.
    toc_rot = rot_pair(2.0 * math.pi / 128.0 * delay[:, None]
                       * k.cn[None, :])                  # (B, 72, 2)
    tfg_c = cmul(tfg_c, toc_rot[:, None])
    keep("toe", tfg_c)

    # ---- channel estimation, 4 ports, at the 28 PBCH rows only.
    ce, np_v = _chan_est_dev(tfg_c[:, :o1], tfg_c[:, o1:o2], tfg_c[:, o2:o3],
                             rs_conj, shifts, n_symb_dl, n_ofdm, k, interp)
    keep("chanest", ce, np_v)

    # ---- PBCH extraction for the 4 frame-timing guesses: the kept REs
    # of each frame's four PBCH symbols, picked by the cell's v_shift.
    nf = k.n_frame
    cols = k.pbch_cols[n_id % 3]                         # (B, nf)
    frames = tfg_c[:, o3:o3 + 28].reshape(B, 7, 288, 2)
    comp = torch.gather(frames, 2,
                        cols[:, None, :, None].expand(B, 7, nf, 2))
    pbch_sym = torch.stack([comp[:, gi:gi + 4].reshape(B, 4 * nf, 2)
                            for gi in range(4)], dim=1)  # (B, 4, n, 2)
    ce_f = ce.reshape(B, 4, 7, 288, 2)
    comp_ce = torch.gather(ce_f, 3,
                           cols[:, None, None, :, None].expand(B, 4, 7, nf, 2))
    pbch_ce = torch.stack([comp_ce[:, :, gi:gi + 4].reshape(B, 4, 4 * nf, 2)
                           for gi in range(4)], dim=2)   # (B, 4p, 4g, n, 2)
    keep("pbch", pbch_sym, pbch_ce)

    # ---- SFBC + QPSK LLR + descramble + deratematch.
    syms, np_sym = _sfbc_dev(pbch_sym, pbch_ce, np_v)
    np_sym = torch.clamp(np_sym, min=1e-30)
    c = float(np.float32(2.0) * np.sqrt(2.0).astype(np.float32))
    llr = torch.stack([c * syms[..., 0] / np_sym, c * syms[..., 1] / np_sym],
                      dim=-1).reshape(B, 4, 3, m_bit)
    llr = llr * scr_sign[:, None, None, :]
    llr_tl = torch.einsum("ce,bgpe->cbgp", k.wd_k, llr)  # (120, B, 4, 3)
    keep("llr", llr_tl)

    # ---- tail-biting Viterbi (the viterbi kernel) + CRC16 port masks.
    Lq = B * 12
    bits_tl = viterbi_tl(llr_tl.reshape(10, 12, Lq).contiguous())  # (40, Lq)
    bits = bits_tl.T.reshape(B, 4, 3, 40)
    keep("vit", bits)
    crc_est = torch.remainder(bits[..., :24] @ k.crc_m, 2).long()
    crc_est = crc_est ^ k.crc_masks[None, None]
    ok = torch.all(crc_est == bits[..., 24:40].long(), dim=-1)  # (B, 4, 3)
    return {"residual_f": residual_f, "ok": ok, "bits": bits}


# ----------------------------------------------------------------------
# Host wrapper.


def _unpack_mib_host(cell: Cell, bits: np.ndarray, n_ports: int,
                     guess: int) -> Cell:
    out = dataclasses.replace(cell)
    out.n_ports = n_ports
    bw = int(bits[0]) * 4 + int(bits[1]) * 2 + int(bits[2])
    out.n_rb_dl = N_RB_DL_TABLE.get(bw, -1)
    out.phich_duration = "extended" if bits[3] else "normal"
    out.phich_resource = PHICH_RES_TABLE[int(bits[4]) * 2 + int(bits[5])]
    sfn_high = 0
    for v in bits[6:14]:
        sfn_high = 2 * sfn_high + int(v)
    out.sfn = int(np.mod(sfn_high * 4 - guess, 1024))
    return out


@dataclasses.dataclass
class MibPending:
    """A MIB program in flight: its outputs (device tensors, or a
    :class:`HostFetch` of them when deferred) and its plan (which holds
    the cells)."""

    out: object
    plan: object


def decode_mib_batch(cells: List[Cell], cap: torch.Tensor,
                     interp: str = "hex", n_cap: Optional[int] = None,
                     cap_bases: Optional[Sequence[int]] = None,
                     defer: bool = False):
    """Extract_tfg + tfoec + chan_est + blind MIB decode for same-CP cells.

    cap (n, 2) f32 on the device: one capture, or with ``cap_bases`` a
    stack of captures of length ``n_cap`` each (default: cap's length).
    ``interp``: "hex" (the reference's enabled interpolator) or
    "freq_time" (the reference documents them as equivalent,
    src/searcher.cpp:1472-1475; "2stage" maps to freq_time).
    Returns updated Cell records; failures keep n_rb_dl == -1.
    ``defer=True`` uploads the plan without waiting for the stream and
    returns a :class:`MibPending` whose results are on their way to the
    host; :func:`finish_mib_batch` collects it.
    """
    if not cells:
        return MibPending(None, None) if defer else []
    plan = mib_plan(cells, cap.shape[0] if n_cap is None else n_cap,
                    cap_bases)
    out = run(cap, plan, interp, non_blocking=defer)
    if defer:
        return MibPending(HostFetch(out), plan)
    return finish_mib_batch(MibPending(out, plan))


def extract_tfg_batch(cells: List[Cell], cap: torch.Tensor,
                      n_cap: Optional[int] = None,
                      cap_bases: Optional[Sequence[int]] = None):
    """The FULL extract_tfg grid of same-CP cells on the device: every
    OFDM row of the reference's 6-frame + 2-slot grid (854 rows normal
    CP, 732 extended; src/searcher.cpp:852-935), demodulated by the
    ``fd_demod`` kernel in one launch from the same plan as the MIB
    program (:func:`mib_plan`), for consumers beyond the MIB chain. The
    MIB program keeps its compact rows; values at shared rows are the
    same arithmetic.

    cap, ``n_cap`` and ``cap_bases`` are those of
    :func:`decode_mib_batch`; fc/fs are read per cell. Returns (tfg (B,
    n_ofdm, 72) complex64, timestamps (B, n_ofdm) float64 from the host's
    :func:`symbol_timestamps_batch`, ok (B,) bool): a cell whose grid
    passes the capture's end gets ok False and meaningless rows.
    """
    if not cells:
        return (np.zeros((0, 0, 72), np.complex64), np.zeros((0, 0)),
                np.zeros(0, bool))
    plan = mib_plan(cells, cap.shape[0] if n_cap is None else n_cap,
                    cap_bases)
    out = fd_demod(cap, *fd_demod_inputs(plan, cap.device, full_grid=True))
    out = to_host(out.view(len(cells), plan.n_ofdm, 72, 2))
    k = np.array([(c.fc_requested - c.freq_fine) / c.fc_programmed
                  for c in cells])
    ts = symbol_timestamps_batch(
        cells[0].cp_type, np.array([c.frame_start for c in cells]),
        np.array([c.fs_programmed for c in cells]), k)
    return ((out[..., 0] + 1j * out[..., 1]).astype(np.complex64), ts,
            plan.ok.copy())


def finish_mib_batch(pending: MibPending) -> List[Cell]:
    """Fetch the results of a MIB program (deferred or not) and unpack the
    first passing (guess, ports) hypothesis of every cell."""
    if pending.plan is None:
        return []
    plan = pending.plan
    o = (pending.out.wait() if isinstance(pending.out, HostFetch)
         else {k: to_host(v) for k, v in pending.out.items()})
    residual_f, ok, bits = o["residual_f"], o["ok"], o["bits"]
    res: List[Cell] = []
    for b, cell in enumerate(plan.cells[:len(residual_f)]):
        c = dataclasses.replace(cell)
        if plan.ok[b]:
            c.freq_superfine = c.freq_fine + float(residual_f[b])
            hits = [(g, pi) for g in range(4) for pi in range(3)
                    if ok[b, g, pi]]
            if hits:
                g, pi = hits[0]
                c = _unpack_mib_host(c, bits[b, g, pi], _PORT_CFGS[pi], g)
        res.append(c)
    return res
