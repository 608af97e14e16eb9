"""Batched multi-cell tracker engine on the device.

Counterpart of lte_cell_scanner_tpu/tracker/batch_runtime.py. Every
per-symbol and per-RS computation for ALL tracked cells runs in a few
device programs per processing cycle —

  demod:  symbol demod of every cell's windows straight from the raw u8
          stream uploaded once per cycle (the ``fd_demod_stream`` CUDA
          kernel, ops/fd_demod.py; PDUs that carry their samples go
          through the same kernel, their u8 windows laid end to end as
          the segment), raw-CE extraction at every RS
          position (RS sequences in device-resident per-cell tables) and
          the PSS/SSS sync measurements of every complete pair
          [batch_frontend.*]
  stats:  CE filtering + FOE/TOE statistics for every RS triple
          (triples are index-gathers against the demod's device-resident
          CE rows), channel-autocorrelation diagnostics aggregated per
          cell on the device
  MIB:    batched tail-biting Viterbi over every cell's full 4-frame PBCH
          windows (the ``viterbi`` CUDA kernel, models/viterbi.py)

— and the host control plane is vectorized NumPy: raw-CE row metadata
lives in arrays per (cell, port), triples are slices, and the sequential
inverse-variance feedback blends (global FO, per-cell frame timing) are
evaluated with their exact closed form

    x_N = P_N x_0 + P_N * sum_k  a_k e_k / P_k,   P_k = prod_{j<=k}(1-a_j)

in the same (cell-major, port, time) order as the reference's per-cell
tracker, chunked to keep the cumulative products in float64 range.

The engine keeps the JAX engine's two link quantizations because they
change numbers: the bulk phase and lateness travel to the device as i16
fixed point (_plan_demod, _dequant_plan), and each program's results
come home in one float16 buffer with the feedback-critical lanes packed
losslessly (_pack).

A cycle's shapes round up to shape buckets (_bucket), and both programs'
plans travel to the device in one upload (_upload). On the card each
program is captured once per bucket as a CUDA graph and replayed every
cycle after (_GraphCache): a one-cell cycle's ~750 small operations cost
one launch each. Padding is invisible to the host: padded lanes index row
0 and padded triples fall into the pad segment C, every operation of
both programs treats rows independently, and the host reads only real
lanes.

Its scope notes hold here too: interpolated channel
estimates are evaluated only at the symbols that consume them (PBCH, sync
and CRS measurement symbols, and a ``ce_observer``'s); the TOE blend wraps relative to the
cycle-start frame timing; ac_fd/ac_td update once per cycle; a PSS/SSS
pair split across a cycle boundary skips its measurement.
"""

from __future__ import annotations

import bisect
import functools
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from lte_cell_scanner_tpu_torch import kernels
from lte_cell_scanner_tpu_torch.constants import FS_LTE
from lte_cell_scanner_tpu_torch.models.crc import lte_calc_crc
from lte_cell_scanner_tpu_torch.models.modulation import lte_demodulate
from lte_cell_scanner_tpu_torch.models.pn import lte_pn
from lte_cell_scanner_tpu_torch.models.pss import pss_fd
from lte_cell_scanner_tpu_torch.models.ratematch import lte_conv_deratematch
from lte_cell_scanner_tpu_torch.models.rs import RSDL
from lte_cell_scanner_tpu_torch.models.sss import sss_fd
from lte_cell_scanner_tpu_torch.models.viterbi import lte_conv_decode_batch
from lte_cell_scanner_tpu_torch.ops.fd_demod import fd_demod_stream
from lte_cell_scanner_tpu_torch.ops.pbch import N_RB_DL_TABLE, PHICH_RES_TABLE
from lte_cell_scanner_tpu_torch.ops.sync_torch import cconj, cmul
from lte_cell_scanner_tpu_torch.tracker import batch_frontend as bf
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell
from lte_cell_scanner_tpu_torch.utils.device import (HostFetch,
                                                     PinnedStaging,
                                                     full_f32_matmuls,
                                                     launch_device,
                                                     resolve_device, to_host)
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

_WRAP = 19200.0
_META = ("seq", "shift", "slot", "sym", "fo", "ft")


def _ladder(lo: int, top: int) -> tuple:
    """Bucket sizes from ``lo`` to the first at or above ``top``, each
    ~1.25x the last and a multiple of 4 (the JAX engine's _bucket)."""
    steps = [lo]
    while steps[-1] < top:
        b = max(steps[-1] + 1, steps[-1] * 5 // 4)
        steps.append(-(-b // 4) * 4)
    return tuple(steps)


# The padded axes of a cycle's programs and their ladders: windows (S),
# PBCH symbols (Q), RS rows (R) and sync pairs (K) per cell, triples (T),
# emit rows (E) and stream samples (L). The cell and port counts are not
# padded.
_LADDERS = {"S": _ladder(4, 2048), "Q": _ladder(4, 256),
            "R": _ladder(4, 2048), "K": _ladder(4, 256),
            "T": _ladder(4, 8192), "E": _ladder(4, 8192),
            "L": _ladder(4096, 1 << 19)}
_GRAPH_KEYS = 16                   # the graph cache's LRU bound


def _bucket(axis: str, n: int) -> int:
    """``n`` rounded up to the next step of ``axis``'s ladder; beyond the
    ladder's top, ``n`` itself (and the cycle runs eagerly)."""
    steps = _LADDERS[axis]
    i = bisect.bisect_left(steps, n)
    return steps[i] if i < len(steps) else n


def _on_ladder(sizes: dict) -> bool:
    """Whether every padded size of ``sizes`` ({axis: size}) is at most
    the top of its axis's ladder."""
    return all(n <= _LADDERS[a][-1] for a, n in sizes.items())


def _empty_meta():
    return {"seq": np.zeros(0, np.int64), "shift": np.zeros(0, np.int64),
            "slot": np.zeros(0, np.int64), "sym": np.zeros(0, np.int64),
            "fo": np.zeros(0, np.float64), "ft": np.zeros(0, np.float64)}


def _cat_meta(a, b):
    return {k: np.concatenate([a[k], b[k]]) for k in _META}


def _tail_meta(m, k):
    return {key: m[key][-k:] if k else m[key][:0] for key in _META}


class _CellCtx:
    """Per-cell bookkeeping the batch engine keeps on host."""

    def __init__(self, cell: TrackedCell):
        self.cell = cell
        self.rs_dl = RSDL(cell.n_id_cell, 6, cell.cp_type)
        m_bit = 1920 if cell.cp_type == "normal" else 1728
        self.scr = lte_pn(cell.n_id_cell, m_bit)
        self.bpo = 0.0  # float64 bulk-phase carry
        self.seq = 0
        n_ports = cell.n_ports
        self.meta_carry = [_empty_meta() for _ in range(n_ports)]
        self.ce_carry = [np.zeros((0, 12), complex) for _ in range(n_ports)]
        self.filt_carry: List[Optional[dict]] = [None] * n_ports
        self.backfilled = [False] * n_ports
        self.horizon = [-1] * n_ports      # seq of latest filtered CE
        self.interp_points: Dict[int, dict] = {}  # seq -> {port: (ce, vals)}
        self.pending: Deque = deque()      # (seq, slot, sym, syms72|None)
        self.sync_vals: Dict[int, tuple] = {}     # pss seq -> measurements
        self.sync_ce_latest: Optional[np.ndarray] = None
        self.mib_fifo: Deque = deque()
        self.mib_fifo_synchronized = False

        n1, n2 = divmod(cell.n_id_cell, 3)
        self.pss_conj = np.conj(pss_fd(n2))
        self.sss0 = sss_fd(n1, n2, 0).astype(np.float64)
        self.sss10 = sss_fd(n1, n2, 10).astype(np.float64)

        # Per-(slot, sym) RS lookup tables (vectorized access; mirrored
        # into a device-resident table by the engine).
        n_symb_dl = cell.n_symb_dl
        self.shift_tab = np.full((20, 7, cell.n_ports), -1, np.int64)
        self.rs_tab = np.zeros((20, 7, 12), complex)
        for slot in range(20):
            for sym in range(n_symb_dl):
                got = False
                for p in range(n_ports):
                    sh = self.rs_dl.get_shift(slot, sym, p)
                    if not np.isnan(sh):
                        self.shift_tab[slot, sym, p] = int(sh)
                        got = True
                if got:
                    self.rs_tab[slot, sym] = self.rs_dl.get_rs(slot, sym)


def _key(cell: TrackedCell):
    return (cell.n_id_cell, cell.serial_num)


def _iir_chain(x0, targets, alphas, chunk=64):
    """Exact closed form of x_k = x_{k-1}(1-a_k) + t_k a_k, chunked so the
    cumulative products stay in float64 range. Returns x_N."""
    n = len(alphas)
    x = x0
    for s in range(0, n, chunk):
        a = alphas[s:s + chunk]
        t = targets[s:s + chunk]
        p = np.cumprod(1.0 - a, axis=0)
        corr = np.sum(a * t / p, axis=0)
        x = p[-1] * (x + corr)
    return x


class BatchTrackerEngine:
    """Tracks any number of cells with shared device programs.

    ``device=None`` runs on the CUDA card and raises if there is none;
    ``device="cpu"`` runs the kernels' plain PyTorch versions. Float32
    matrix products run in full float32 (TF32 off): the CE filter and the
    sync measurements feed the FOE/TOE loops.
    """

    def __init__(self, state: GlobalState, device=None):
        self.state = state
        self.device = resolve_device(device)
        full_f32_matmuls()
        self.ctx: Dict[tuple, _CellCtx] = {}
        # Raw uint8 sample ring: the stream is uploaded ONCE per cycle and
        # every cell's symbol windows are gathered from it on the device —
        # host->device traffic is ~3.8 MB per signal-second TOTAL,
        # independent of the cell count.
        self._blocks: Deque = deque()      # (abs_base, (n, 2) uint8)
        self._stream_end = 0
        self._dev_tables = None            # device RS/sync tables
        self._dev_key = None
        # Optional per-symbol CE tap: a (filter(slot, sym),
        # callback(n_id_cell, slot, sym, ce (n_ports, 72), sp (n_ports,),
        # np (n_ports,))) pair. The engine interpolates CE only at the
        # symbols something consumes; the filter's symbols become
        # consumers (the same bracketing interpolation) and reach the
        # callback in order once finalized.
        self.ce_observer = None
        # ac_td rolling raw-CE history: DEVICE-RESIDENT engine state
        # (Cp, 72, 12, 2) f32 — updated by every stats program, never
        # fetched; counts gate the first IIR assignment at 72 rows
        # (reference contract: the 72-deep FIFO of do_ac_td).
        self._td = None                    # {"key", "H", "count"}
        # On the card: the programs' CUDA graphs per shape bucket, and the
        # pinned host buffers of the cycle's one upload.
        cuda = self.device.type == "cuda"
        self._graphs = _GraphCache(self.device) if cuda else None
        self._staging = PinnedStaging(self.device) if cuda else None

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def push_raw(self, raw_block: np.ndarray) -> None:
        """Append one block of interleaved uint8 IQ to the sample ring."""
        arr = np.asarray(raw_block, dtype=np.uint8).reshape(-1, 2)
        self._blocks.append((self._stream_end, arr))
        self._stream_end += len(arr)

    def _stream_segment(self, lo: int, hi: int) -> np.ndarray:
        """Materialize stream samples [lo, hi) and prune older blocks."""
        while self._blocks and self._blocks[0][0] + len(
                self._blocks[0][1]) <= lo:
            self._blocks.popleft()
        parts = []
        for base, arr in self._blocks:
            if base >= hi:
                break
            a = max(0, lo - base)
            b = min(len(arr), hi - base)
            if a < b:
                parts.append(arr[a:b])
        seg = np.concatenate(parts) if parts else np.zeros((0, 2), np.uint8)
        if len(seg) != hi - lo:
            raise RuntimeError("stream ring is missing samples")
        return seg

    # ------------------------------------------------------------------
    def _tables(self, work):
        """Device-resident per-cell ROM tables, rebuilt when the tracked
        cell set changes."""
        key = tuple(_key(c) for c, _ in work)
        P = max(c.n_ports for c, _ in work)
        if self._dev_key == (key, P):
            return self._dev_tables
        C = len(work)
        rs_conj_tab = np.zeros((C, 20, 7, 12, 2), np.float32)
        shift_tab = np.zeros((C, 20, 7, P), np.int64)
        pss_conj = np.zeros((C, 62, 2), np.float32)
        sss_tab = np.zeros((C, 2, 62), np.float32)
        for ci, (cell, _) in enumerate(work):
            ctx = self.ctx[_key(cell)]
            rs_conj_tab[ci] = bf.to_ri(np.conj(ctx.rs_tab))
            shift_tab[ci, :, :, :cell.n_ports] = np.maximum(
                ctx.shift_tab, 0)
            pss_conj[ci] = bf.to_ri(ctx.pss_conj)
            sss_tab[ci, 0] = ctx.sss0
            sss_tab[ci, 1] = ctx.sss10
        self._dev_tables = tuple(self._up(x) for x in (
            rs_conj_tab, shift_tab, pss_conj, sss_tab))
        self._dev_key = (key, P)
        return self._dev_tables

    # ------------------------------------------------------------------
    def _td_align(self, work, C: int, P: int) -> None:
        """Re-key the device-resident ac_td history to the current cell
        set (device gather for retained cells, zeros + count 0 for new
        ones); no-op while the set is stable."""
        key = (tuple(_key(c) for c, _ in work), P, C)
        if self._td is not None and self._td["key"] == key:
            return
        Cp = C * P
        count = np.zeros(Cp, np.int64)
        if self._td is None:
            H = torch.zeros((Cp, 72, 12, 2), dtype=torch.float32,
                            device=self.device)
        else:
            old_keys, oldP, _ = self._td["key"]
            old_index = {k: i for i, k in enumerate(old_keys)}
            perm = np.full(Cp, -1, np.int64)
            for ci, (cell, _) in enumerate(work):
                oi = old_index.get(_key(cell))
                if oi is not None:
                    for port in range(min(P, oldP)):
                        perm[ci * P + port] = oi * oldP + port
            valid = perm >= 0
            permc = np.where(valid, perm, 0)
            H = torch.where(self._up(valid)[:, None, None, None],
                            self._td["H"][self._up(permc)], 0.0)
            count[valid] = self._td["count"][permc[valid]]
        self._td = {"key": key, "H": H, "count": count}

    # ------------------------------------------------------------------
    @TRACER.traced("engine")
    def process_all(self, cells: List[TrackedCell]) -> None:
        """One engine cycle over ``cells``: the tracer's span ``engine``,
        its stages ``engine.demod`` (plan, upload and dispatch, then
        ingestion), ``engine.route``, ``engine.stats`` (plan and dispatch,
        then finish) and ``engine.finalize`` (with the MIB decode); the
        counters ``engine.cell_cycles`` (the cells that had symbols this
        cycle) and ``engine.mib_decodes`` (each MIB the cycle decoded)."""
        cells = [c for c in cells if not c.kill_me]
        live = {_key(c) for c in cells}
        for k in list(self.ctx):
            if k not in live:
                del self.ctx[k]
        for c in cells:
            if _key(c) not in self.ctx:
                self.ctx[_key(c)] = _CellCtx(c)
            # Overload policy (reference: tracker_thread.cpp:856-867).
            n_ofdm_1s = c.n_symb_dl * 2 * 1000
            while len(c.fifo) > n_ofdm_1s * 1.5:
                for _ in range(n_ofdm_1s):
                    c.fifo.popleft()
                self.state.cell_seconds_dropped += 1

        work = [(c, list(c.fifo)) for c in cells if c.fifo]
        for c, _ in work:
            c.fifo.clear()
        TRACER.count("engine.cell_cycles", len(work))
        if work:
            # Both plans are made on the host first (the stats plan needs
            # only host-side metadata) and travel in one upload. The stats
            # program is dispatched BEFORE the demod results are fetched,
            # so the demod fetch's round trip overlaps the stats compute
            # instead of idling the device.
            with TRACER.span("engine.demod"):
                cyc = self._plan_demod(work)
            with TRACER.span("engine.route"):
                self._host_route(work, cyc)
            sp = None
            try:
                try:
                    with TRACER.span("engine.stats"):
                        sp = self._plan_stats(work, cyc)
                finally:
                    with TRACER.span("engine.demod"):
                        self._dispatch_demod(cyc, sp)
                if sp is not None:
                    with TRACER.span("engine.stats"):
                        self._dispatch_stats(cyc, sp)
            finally:
                # Always land the demod values: an error in the stats half
                # must not leave permanent None placeholders in
                # ctx.pending.
                if "flat" in cyc:
                    with TRACER.span("engine.demod"):
                        self._ingest_demod(work, cyc)
            if sp is not None:
                with TRACER.span("engine.stats"):
                    self._stats_finish(work, sp)
        else:
            self._prune_ring()
        with TRACER.span("engine.finalize"):
            self._finalize(cells)

    def _prune_ring(self) -> None:
        """Keep ~2 s of the sample ring when nothing consumes it (the
        searcher still hunting, every cell dropped, or PDUs that carry
        their samples), so that it cannot grow unboundedly."""
        keep_from = self._stream_end - 2 * 1920 * 1000
        while (len(self._blocks) > 1 and self._blocks[0][0]
               + len(self._blocks[0][1]) < keep_from):
            self._blocks.popleft()

    # ------------------------------------------------------------------
    def _plan_demod(self, work):
        """Demod program (plan): the host arrays that drive it. The
        program demods every pending symbol of every cell from the
        uploaded raw stream, extracts raw CE at every RS position and
        computes the sync-pair measurements. Only PBCH symbols, sync
        measurement results and the tiny metadata come home — the symbol
        grid and the raw CE rows stay on the device. Returns the cycle's
        dict, its plan under "plan" at bucketed shapes."""
        state = self.state
        C = len(work)
        S = _bucket("S", max(len(p) for _, p in work))
        P = max(c.n_ports for c, _ in work)
        cyc = {"cells": [], "C": C, "P": P}

        # Descriptor PDUs carry their window's stream index; sample-
        # carrying PDUs (feeder emit_descriptors=False) carry the samples.
        stream_mode = work[0][1][0].start is not None
        if stream_mode:
            starts = np.zeros((C, S), np.int64)
        else:
            data = np.zeros((C, S, 128, 2), np.uint8)
        foc_rate = np.zeros((C, S), np.float32)
        late = np.zeros((C, S), np.float32)
        fo = np.zeros((C, S), np.float64)
        n_samp = np.full((C, S), 128.0 + 9.0)
        bpo0 = np.zeros(C, np.float64)

        for ci, (cell, pdus) in enumerate(work):
            ctx = self.ctx[_key(cell)]
            bpo0[ci] = ctx.bpo
            n_symb_dl = cell.n_symb_dl
            n = len(pdus)
            if stream_mode:
                starts[ci, :n] = np.fromiter(
                    (p.start for p in pdus), np.int64, n)
            else:
                # The samples back to the u8 levels they were fed as.
                blk = np.stack([p.data for p in pdus])      # (n, 128)
                data[ci, :n, :, 0] = np.round(blk.real * 128.0 + 127.0)
                data[ci, :n, :, 1] = np.round(blk.imag * 128.0 + 127.0)
            # One pass over the PDU objects for all metadata fields.
            meta_np = np.array([(p.frequency_offset, p.late, p.sym_num,
                                 p.slot_num, p.frame_timing)
                                for p in pdus], np.float64)
            fo_c = meta_np[:, 0]
            fo[ci, :n] = fo_c
            k = (state.fc_requested - fo_c) / state.fc_programmed
            foc_rate[ci, :n] = -2 * np.pi * fo_c / (state.fs_programmed * k)
            late[ci, :n] = meta_np[:, 1]
            syms_n = meta_np[:, 2].astype(np.int64)
            slots = meta_np[:, 3].astype(np.int64)
            fts = meta_np[:, 4]
            if cell.cp_type == "extended":
                n_samp[ci, :n] = 128 + 32
            else:
                n_samp[ci, :n] = np.where(syms_n == 0, 128 + 10, 128 + 9)
            is_sync_slot = (slots == 0) | (slots == 10)
            keep = np.nonzero((slots == 1) & (syms_n <= 3))[0]   # PBCH
            sync_meta = np.nonzero(is_sync_slot
                                   & (syms_n >= n_symb_dl - 2))[0]
            # Complete SSS->PSS pairs inside this cycle.
            sss_i = np.nonzero(is_sync_slot & (syms_n == n_symb_dl - 2))[0]
            pairs = [(si, si + 1) for si in sss_i
                     if si + 1 < n and syms_n[si + 1] == n_symb_dl - 1
                     and slots[si + 1] == slots[si]]
            has_rs = (ctx.shift_tab[slots, syms_n] >= 0).any(axis=1)
            rs_sel = np.nonzero(has_rs)[0]
            cyc["cells"].append({
                "slots": slots, "syms": syms_n, "fo": fo_c, "ft": fts,
                "rs_sel": rs_sel, "keep": keep, "sync_meta": sync_meta,
                "pairs": pairs, "n": n,
                "shift_r": ctx.shift_tab[slots[rs_sel], syms_n[rs_sel]],
            })

        # Padded lanes index row 0 of their axis (always in range; the
        # host never reads their results).
        Q = _bucket("Q", max(1, max(len(i["keep"]) for i in cyc["cells"])))
        R = _bucket("R", max(1, max(len(i["rs_sel"]) for i in cyc["cells"])))
        K = _bucket("K", max(1, max(len(i["pairs"]) for i in cyc["cells"])))
        keep_idx = np.zeros((C, Q), np.int64)
        rs_idx = np.zeros((C, R), np.int64)
        rs_slot = np.zeros((C, R), np.int64)
        rs_sym = np.zeros((C, R), np.int64)
        pair_idx = np.zeros((C, K, 2), np.int64)
        pair_sel = np.zeros((C, K), np.int64)
        for ci, info in enumerate(cyc["cells"]):
            keep_idx[ci, :len(info["keep"])] = info["keep"]
            sel = info["rs_sel"]
            rs_idx[ci, :len(sel)] = sel
            rs_slot[ci, :len(sel)] = info["slots"][sel]
            rs_sym[ci, :len(sel)] = info["syms"][sel]
            for pi, (a, b) in enumerate(info["pairs"]):
                pair_idx[ci, pi] = (a, b)
                pair_sel[ci, pi] = 0 if info["slots"][a] == 0 else 1

        bpo, _carry = bf.bulk_phase_offsets(bpo0, fo, n_samp)
        for ci, (cell, pdus) in enumerate(work):
            self.ctx[_key(cell)].bpo = float(bpo[ci, len(pdus) - 1])

        # Link quantization of the JAX engine, kept because it changes
        # numbers (see _dequant_plan): bpo as i16 turn fractions (wrapped
        # to +-pi above, so the modular i16 wrap is exact), late as i16
        # 2^-13-sample fixed point. A lateness out of range travels as
        # f32 rather than clipping.
        q = np.round(bpo * (65536.0 / (2.0 * np.pi)))
        bpo_u = ((q + 32768) % 65536 - 32768).astype(np.int16)
        if np.abs(late).max(initial=0.0) < 3.99:
            late_u = np.round(late * 8192.0).astype(np.int16)
        else:
            late_u = late.astype(np.float32)

        self._tables(work)
        if stream_mode:
            # The windows of every cell lie in [lo, hi): upload exactly
            # that span of the stream, padded with zeros to its bucket. A
            # window's lanes read samples [s, s + 128) only, so nothing
            # reads past hi; padded windows start at lo.
            lo = min(int(starts[ci, :info["n"]].min())
                     for ci, info in enumerate(cyc["cells"]))
            hi = max(int(starts[ci, :info["n"]].max())
                     for ci, info in enumerate(cyc["cells"])) + 128
            L = _bucket("L", hi - lo)
            seg = np.zeros((L, 2), np.uint8)
            seg[:hi - lo] = self._stream_segment(lo, hi)
            head = {"seg": seg,
                    "starts": (starts - lo).clip(0).astype(np.int32)}
            cyc["ladder"] = _on_ladder({"S": S, "Q": Q, "R": R, "K": K,
                                        "L": L})
        else:
            self._prune_ring()
            head = {"data": data}
            cyc["ladder"] = False
        cyc.update(plan=dict(
            head, foc_rate=foc_rate, bpo_u=bpo_u, late_u=late_u,
            rs_idx=rs_idx, rs_slot=rs_slot, rs_sym=rs_sym,
            keep_idx=keep_idx, pair_idx=pair_idx, pair_sel=pair_sel),
            Q=Q, K=K, R=R, patch=[])
        return cyc

    def _upload(self, cyc, sp) -> dict:
        """Both programs' plans (``sp`` None: the demod's alone) packed
        into one host buffer and moved to the device in one copy. On the
        card the buffer is pinned and the copy does not block; a cycle on
        its shape buckets' ladders copies into its graphs' static buffer
        (``cyc["graphs"]``, else None) and loads the engine state they
        read. Returns the plan's arrays as device tensors by name."""
        arrays = dict(cyc["plan"], **(sp["plan"] if sp is not None else {}))
        offsets, nbytes = _layout(arrays.values())
        td = self._td["H"] if sp is not None else None
        graphs = None
        if self._graphs is not None and cyc["ladder"] and (
                sp is None or sp["ladder"]):
            key = tuple((k, a.shape, a.dtype.str) for k, a in arrays.items())
            graphs = self._graphs.entry(key, nbytes, self._dev_tables, td)
        host = (torch.empty(nbytes, dtype=torch.uint8)
                if self._staging is None else self._staging.take(nbytes))
        _write(host.numpy(), arrays.values(), offsets)
        if graphs is not None:
            buf = graphs.plan.copy_(host[:nbytes], non_blocking=True)
            # Before the cycle's first replay: a graph's intermediates may
            # reuse the memory of another graph's outputs, the ac_td
            # history among them.
            graphs.load(self._dev_tables, td)
        elif self._staging is not None:
            buf = host[:nbytes].to(self.device, non_blocking=True)
        else:                              # the CPU: views of the buffer
            buf = host
        if self._staging is not None:
            self._staging.sent()
        cyc["graphs"] = graphs
        return dict(zip(arrays, _views(buf, arrays.values(), offsets)))

    def _dispatch_demod(self, cyc, sp) -> None:
        """Demod program (dispatch): the cycle's one upload, then the
        program. Its fetch is enqueued HERE, first, so it starts as soon
        as the program finishes; it is consumed in _ingest_demod, after
        the stats dispatch."""
        dev = cyc["dev"] = self._upload(cyc, sp)
        graphs = cyc["graphs"]
        rs_conj_tab, shift_tab, pss_conj, sss_tab = (
            graphs.tables if graphs is not None else self._dev_tables)
        plan = (dev["foc_rate"], dev["bpo_u"], dev["late_u"], rs_conj_tab,
                shift_tab, dev["rs_idx"], dev["rs_slot"], dev["rs_sym"],
                dev["keep_idx"], dev["pair_idx"], dev["pair_sel"], pss_conj,
                sss_tab)
        if "seg" in dev:
            flat, ce_dev = _program("_demod_stream",
                                    (dev["seg"], dev["starts"]) + plan,
                                    graphs)
        else:
            flat, ce_dev = _program("_demod_samples", (dev["data"],) + plan)
        cyc.update(flat=HostFetch({"flat": flat}), ce_dev=ce_dev)

    # ------------------------------------------------------------------
    def _ingest_demod(self, work, cyc) -> None:
        """Land the demod program's packed results on host: patch the
        pending PBCH placeholders with their demodulated symbols, stage
        the sync measurements. Runs AFTER the stats dispatch so this
        round trip overlaps device compute; everything filled here is
        only consumed from _stats_finish/_finalize onward."""
        kept, s_tp, s_sp, s_np, s_npb, s_ce = _unpack(
            cyc["flat"].wait()["flat"],
            demod_shapes(cyc["C"], cyc["Q"], cyc["K"]))
        kept_c = {}
        for ctx, pos, ci, qi in cyc["patch"]:
            if ci not in kept_c:
                kept_c[ci] = bf.from_ri(kept[ci])
            seq, slot, sym, _ = ctx.pending[pos]
            ctx.pending[pos] = (seq, slot, sym, kept_c[ci][qi])
        for ci, (cell, _) in enumerate(work):
            ctx = self.ctx[_key(cell)]
            info = cyc["cells"][ci]
            seq0 = info["seq0"]
            for pi, (a, b) in enumerate(info["pairs"]):
                ctx.sync_vals[seq0 + b] = (
                    int(info["slots"][a]), float(s_tp[ci, pi]),
                    float(s_sp[ci, pi]), float(s_np[ci, pi]),
                    float(s_npb[ci, pi]))
            if info["pairs"]:
                # display CE of the cell's last pair this cycle
                ctx.sync_ce_latest = bf.from_ri(s_ce[ci])

    # ------------------------------------------------------------------
    def _host_route(self, work, cyc) -> None:
        """Assign sequence numbers; queue sync/PBCH symbols (their
        demodulated values arrive later — _ingest_demod patches the
        placeholders after the stats dispatch); build raw-CE row
        METADATA per (cell, port) (values stay on the device)."""
        for ci, (cell, pdus) in enumerate(work):
            ctx = self.ctx[_key(cell)]
            info = cyc["cells"][ci]
            seq0 = ctx.seq
            ctx.seq += info["n"]
            info["seq0"] = seq0
            interesting = {}                  # si -> kept index or None
            for qi, si in enumerate(info["keep"]):
                interesting[int(si)] = qi
            for si in info["sync_meta"]:
                interesting.setdefault(int(si), None)
            obs = self.ce_observer
            if obs is not None:
                for si in range(info["n"]):
                    if obs[0](int(info["slots"][si]),
                              int(info["syms"][si])):
                        interesting.setdefault(si, None)
            for si in sorted(interesting):
                if interesting[si] is not None:
                    cyc["patch"].append((ctx, len(ctx.pending), ci,
                                         interesting[si]))
                ctx.pending.append((seq0 + si, int(info["slots"][si]),
                                    int(info["syms"][si]), None))
            rows_per_port = []
            for port in range(cell.n_ports):
                present = info["shift_r"][:, port] >= 0      # (Rc,)
                ri = np.nonzero(present)[0]
                sel = info["rs_sel"][ri]
                meta = {
                    "seq": seq0 + sel,
                    "shift": info["shift_r"][ri, port],
                    "slot": info["slots"][sel],
                    "sym": info["syms"][sel],
                    "fo": info["fo"][sel],
                    "ft": info["ft"][sel],
                }
                rows_per_port.append((meta, ri))
            info["rows"] = rows_per_port

    # ------------------------------------------------------------------
    def _plan_stats(self, work, cyc):
        """Stats program (plan): every complete RS triple gathered on the
        device from the demod's CE rows + the uploaded 2-row carry.
        Planning needs only host-side metadata, so this runs before the
        demod dispatch; returns the pending-state dict for _stats_finish,
        its plan under "plan" at bucketed shapes (or None when there is
        nothing to do)."""
        C, P, R = cyc["C"], cyc["P"], cyc["R"]
        carry_vals = np.zeros((C, P, 2, 12, 2), np.float32)
        carry_idx = np.zeros((C, P, 2), np.int64)
        segments = []   # (ctx, ci, port, meta_full, t0, t1)
        total = 0
        for ci, (cell, _) in enumerate(work):
            ctx = self.ctx[_key(cell)]
            for port in range(cell.n_ports):
                meta_new, ri = cyc["cells"][ci]["rows"][port]
                carry_meta = ctx.meta_carry[port]
                n_car = len(carry_meta["seq"])
                if n_car:
                    carry_vals[ci, port, :n_car] = bf.to_ri(
                        ctx.ce_carry[port][-n_car:])
                meta = _cat_meta(carry_meta, meta_new)
                # combined row index space: carry block, then this
                # cycle's ce rows (flattened (C, R, P)).
                base_car = (ci * P + port) * 2
                idx_car = base_car + np.arange(n_car)
                idx_new = C * P * 2 + (ci * R + ri) * P + port
                ri_comb = np.concatenate([idx_car, idx_new]).astype(np.int64)
                n_tri = max(0, len(meta["seq"]) - 2)
                segments.append((ctx, ci, port, meta, total, total + n_tri,
                                 ri_comb))
                total += n_tri
                # Next cycle's carry: metadata now; values fetched below.
                n_keep = min(2, len(ri_comb))
                ctx.meta_carry[port] = _tail_meta(meta, n_keep)
                carry_idx[ci, port, 2 - n_keep:] = ri_comb[-n_keep:] \
                    if n_keep else 0
                segments[-1] += (n_keep,)
        if total == 0 and not any(s[-1] for s in segments):
            return None

        # Padded triple rows gather row 0 and fall into the extra segment C.
        T = _bucket("T", max(1, total))
        tri = np.zeros((T, 3), np.int64)
        pl = np.zeros(T, bool)
        seg_id = np.full(T, C, np.int64)
        emit_rows = []                         # triple indices to fetch
        for ctx, ci, port, meta, t0, t1, ri_comb, n_keep in segments:
            if t1 == t0:
                continue
            tri[t0:t1, 0] = ri_comb[:-2]
            tri[t0:t1, 1] = ri_comb[1:-1]
            tri[t0:t1, 2] = ri_comb[2:]
            pl[t0:t1] = meta["shift"][:-2] < meta["shift"][1:-1]
            seg_id[t0:t1] = ci
            # which filt rows the interp consumers need: brackets of
            # pending sync/PBCH symbols + the final row (carry).
            fseq = meta["seq"][1:-1]
            cand = np.array([s for (s, *_r) in ctx.pending
                             if s < fseq[-1]], dtype=np.int64)
            need = {t1 - 1 - t0}
            if len(cand):
                j = np.clip(np.searchsorted(fseq, cand, side="right") - 1,
                            0, max(0, len(fseq) - 2))
                need.update(j.tolist())
                need.update(np.minimum(j + 1, len(fseq) - 1).tolist())
            emit_rows.append(t0 + np.array(sorted(need), dtype=np.int64))
        emit_idx = np.concatenate(emit_rows) if emit_rows \
            else np.zeros(0, np.int64)
        E = _bucket("E", max(1, len(emit_idx)))
        emit_pad = np.zeros(E, np.int64)
        emit_pad[:len(emit_idx)] = emit_idx

        # ac_td rolling-history plan: shift this cycle's newest
        # min(72, n_rs) center rows into the device-resident history
        # (right-aligned indices; see _stats), and update the IIR once
        # per cycle once a cell has accumulated the reference's 72-row
        # FIFO depth. On the CROSSING cycle the correlation window is
        # planned to end exactly at the 72nd row ever (the reference's
        # first — and, under the w0 = 1e5 IIR, forever dominant —
        # snapshot); afterwards it is the newest 72 rows.
        self._td_align(work, C, P)
        Cp = C * P
        td_rows = np.zeros((Cp, 72), np.int64)
        td_new = np.zeros(Cp, np.int64)
        td0_rows = np.zeros((Cp, 72), np.int64)
        td0_new = np.zeros(Cp, np.int64)
        td0_sp = np.zeros(Cp, np.int64)
        count = self._td["count"]
        for ctx, ci, port, meta, t0, t1, ri_comb, n_keep in segments:
            n_rs = t1 - t0
            k = ci * P + port
            n_new = min(72, n_rs)
            if not n_new:
                continue
            td_rows[k, 72 - n_new:] = ri_comb[1 + n_rs - n_new:1 + n_rs]
            td_new[k] = n_new
            before = count[k]
            count[k] += n_rs
            if before < 72 <= count[k]:
                # First snapshot: window ends at the 72nd row ever,
                # i.e. after the first (72 - before) rows of this
                # cycle's segment (the earlier rows sit in td_hist).
                n0 = 72 - before
                td0_rows[k, 72 - n0:] = ri_comb[1:1 + n0]
                td0_new[k] = n0
                td0_sp[k] = t0 + n0 - 1
            else:
                td0_rows[k] = td_rows[k]
                td0_new[k] = n_new
                td0_sp[k] = t1 - 1
        td_ok = (td_new > 0) & (count >= 72)

        return dict(plan=dict(
            carry_vals=carry_vals, tri=tri, pl=pl, seg_id=seg_id,
            emit_pad=emit_pad, carry_idx=carry_idx, td_rows=td_rows,
            td_new=td_new, td0_rows=td0_rows, td0_new=td0_new,
            td0_sp=td0_sp), ladder=_on_ladder({"T": T, "E": E}), T=T, E=E,
            C=C, P=P, total=total, segments=segments, emit_idx=emit_idx,
            td_ok=td_ok)

    def _dispatch_stats(self, cyc, sp) -> None:
        """Stats program (dispatch), on the plan the demod's upload
        carried. The new ac_td history stays on the device, never
        fetched; the fetch starts now, and _stats_finish consumes it after
        the demod ingestion has had its round trip."""
        dev, graphs = cyc["dev"], cyc["graphs"]
        flat, self._td["H"] = _program("_stats", (
            cyc["ce_dev"], dev["carry_vals"], dev["tri"], dev["pl"],
            dev["seg_id"], dev["emit_pad"], dev["carry_idx"], dev["td_rows"],
            dev["td_new"], dev["td0_rows"], dev["td0_new"], dev["td0_sp"],
            graphs.td if graphs is not None else self._td["H"], cyc["C"] + 1),
            graphs)
        sp["flat"] = HostFetch({"flat": flat})

    def _stats_finish(self, work, sp) -> None:
        """Stats program (finish half): fetch + the vectorized feedback
        blends in host order."""
        T, E, C, P = sp["T"], sp["E"], sp["C"], sp["P"]
        total, segments = sp["total"], sp["segments"]
        emit_idx = sp["emit_idx"]
        (foe_ang, foe_np, delay, delay_np, ce_filt_e, scal_e,
         ac_sum, acw_sum, carry_out, td_xc) = _unpack(
             sp["flat"].wait()["flat"], stats_shapes(T, E, C, P))
        td_ok = sp["td_ok"]

        # Store next cycle's carry values (host side, robust to cell-set
        # changes between cycles).
        for ctx, ci, port, meta, t0, t1, ri_comb, n_keep in segments:
            ce2 = carry_out[ci, port, :, :, 0] + 1j * carry_out[ci, port,
                                                                :, :, 1]
            ctx.ce_carry[port] = ce2[2 - n_keep:]

        if total == 0:
            return

        state = self.state
        # ---- global FO blend: exact closed form in host (triple) order.
        fo_p = np.concatenate([m["fo"][:-2][:t1 - t0]
                               for _, _, _, m, t0, t1, _, _ in segments]
                              or [np.zeros(0)])
        ft_p = np.concatenate([m["ft"][:-2][:t1 - t0]
                               for _, _, _, m, t0, t1, _, _ in segments]
                              or [np.zeros(0)])
        ft_n = np.concatenate([m["ft"][2:][:t1 - t0]
                               for _, _, _, m, t0, t1, _, _ in segments]
                              or [np.zeros(0)])
        kf = (state.fc_requested - fo_p) / state.fc_programmed
        dt = 0.0005 + (np.mod(ft_n - ft_p + _WRAP / 2, _WRAP) - _WRAP / 2) \
            / (state.fs_programmed * kf)
        est = fo_p + foe_ang[:total].astype(np.float64) / (2 * np.pi) / dt
        est_np = np.maximum(foe_np[:total] / 2, 0.001)
        w_new = 1.0 / est_np
        alphas = w_new / (1e6 + w_new)      # prior_np = 1e-6
        state.frequency_offset = float(_iir_chain(
            state.frequency_offset, est, alphas))

        # Map fetched emit rows back to positions in the fetch arrays.
        emit_map = {int(g): i for i, g in enumerate(emit_idx)}

        for ctx, ci, port, meta, t0, t1, ri_comb, n_keep in segments:
            if t1 == t0:
                continue
            cell = ctx.cell
            # TOE: targets relative to cycle-start frame timing.
            ft0 = cell.frame_timing
            base = meta["ft"][1:-1]
            tgt_raw = base + delay[t0:t1]
            u = ft0 + (np.mod(tgt_raw - ft0 + _WRAP / 2, _WRAP) - _WRAP / 2)
            w = 1.0 / np.maximum(delay_np[t0:t1], 1e-12)
            al = w / (1e4 + w)               # prior_np = 1e-4
            cell.frame_timing = float(np.mod(
                _iir_chain(ft0, u, al), _WRAP))

            self._emit_interp(ctx, port, meta, t0, t1, ce_filt_e, scal_e,
                              emit_map)
            ctx.horizon[port] = int(meta["seq"][-2])

            # ac_td: once per cycle from the segment's last 72
            # CONSECUTIVE raw-CE rows, correlated on the device (_stats
            # td_xc) — lag measured in RS symbols exactly as the
            # reference's per-row history (src/tracker_thread.cpp:
            # 318-370). Cycles shorter than 72 RS rows skip the update.
            k = ci * P + port
            if td_ok[k]:
                xc = td_xc[k, :, 0] + 1j * td_xc[k, :, 1]
                if np.all(np.isfinite(xc)):
                    if cell.ac_td is None:
                        cell.ac_td = xc
                    else:
                        w0 = 1e5
                        cell.ac_td = (cell.ac_td * w0 + xc) / (w0 + 1)

        # ---- per-cell AC diagnostics (aggregated on the device).
        for ci, (cell, _) in enumerate(work):
            acs = ac_sum[ci, :, 0] + 1j * ac_sum[ci, :, 1]
            ws = acw_sum[ci]
            if not np.any(ws) or not (np.all(np.isfinite(acs))
                                      and np.all(np.isfinite(ws))):
                continue
            if cell.ac_fd is None:
                cell.ac_fd = acs / np.maximum(ws, 1e-30)
            else:
                w0 = 1e5
                cell.ac_fd = (cell.ac_fd * w0 + acs) / (w0 + ws)

    # ------------------------------------------------------------------
    def _emit_interp(self, ctx: _CellCtx, port: int, meta, t0, t1,
                     ce_filt_e, scal_e, emit_map) -> None:
        """Bracketing interpolation at the pending sync/PBCH symbols
        covered by this cycle's filtered-CE pairs (fetched emit rows) —
        vectorized over the candidate symbols."""
        cell = ctx.cell
        fseq = meta["seq"][1:-1]
        fshift = meta["shift"][1:-1]
        fsym = meta["sym"][1:-1]
        n_f = len(fseq)

        def filt_at(j):
            i = emit_map.get(t0 + j)
            if i is None:
                return None
            ce = ce_filt_e[i, :, 0] + 1j * ce_filt_e[i, :, 1]
            tp, sp, sp_raw, np_ = scal_e[i]
            return {"ce_filt": ce, "tp": tp, "sp": sp, "sp_raw": sp_raw,
                    "np_": np_, "seq": int(fseq[j]),
                    "shift": int(fshift[j]), "sym": int(fsym[j])}

        carry = ctx.filt_carry[port]
        first = not ctx.backfilled[port]
        lo_seq = int(carry["seq"]) if carry is not None else int(fseq[0])
        hi_seq = int(fseq[-1])
        cand = [s for (s, _slot, _sym, _) in ctx.pending
                if s < hi_seq and (s >= lo_seq or first)]
        if cand:
            ctx.backfilled[port] = True
            sv = np.asarray(cand, np.int64)
            # Bracket rows per candidate: carry row for pre-window symbols
            # when a carry exists, else backfill from row 0 (a = 0).
            j = np.clip(np.searchsorted(fseq, sv, "right") - 1, 0,
                        max(0, n_f - 2))
            pre = sv < int(fseq[0])
            jp = np.where(pre, 0, j)
            jn = np.where(pre, min(1, n_f - 1) if carry is None else 0,
                          np.minimum(j + 1, n_f - 1))
            use_carry = pre if carry is not None else np.zeros_like(pre)

            # Emit-row values per bracket row (rows are all in the emit
            # set by construction; a missing row voids its candidates).
            row_of = {int(x): emit_map.get(t0 + int(x), -1)
                      for x in np.unique(np.concatenate([jp, jn]))}
            ip = np.array([row_of[int(x)] for x in jp])
            in_ = np.array([row_of[int(x)] for x in jn])
            ok = (ip >= 0) & (in_ >= 0)

            ce_rows = ce_filt_e[..., 0] + 1j * ce_filt_e[..., 1]  # (E,12)
            m6 = np.stack([_interp72_mat(s6) for s6 in range(6)])
            p_ce = ce_rows[ip]
            p_shift = fshift[jp].astype(np.int64)
            p_sym = fsym[jp].astype(np.int64)
            p_seq = fseq[jp].astype(np.int64)
            p_scal = scal_e[ip]                       # (N, 4)
            if carry is not None and use_carry.any():
                p_ce[use_carry] = carry["ce_filt"]
                p_shift[use_carry] = carry["shift"]
                p_sym[use_carry] = carry["sym"]
                p_seq[use_carry] = carry["seq"]
                p_scal[use_carry] = [carry["tp"], carry["sp"],
                                     carry["sp_raw"], carry["np_"]]
            n_ce = ce_rows[in_]
            n_shift = fshift[jn].astype(np.int64)
            n_scal = scal_e[in_]

            steps = sv - p_seq
            a = np.zeros(len(sv))
            for key in set(zip(p_sym.tolist(), steps.tolist())):
                if key[1] >= 0:
                    sel = (p_sym == key[0]) & (steps == key[1])
                    a[sel] = _a_value(cell.cp_type, port, int(key[0]),
                                      int(key[1]))
            ce_p = np.einsum("nij,nj->ni", m6[p_shift], p_ce)
            ce_n = np.einsum("nij,nj->ni", m6[n_shift], n_ce)
            ce_all = ce_p * (1 - a)[:, None] + ce_n * a[:, None]
            v_all = p_scal * (1 - a)[:, None] + n_scal * a[:, None]
            pts = ctx.interp_points
            for i, s in enumerate(cand):
                if not ok[i]:
                    continue
                vals = {"tp": float(v_all[i, 0]), "sp": float(v_all[i, 1]),
                        "sp_raw": float(v_all[i, 2]),
                        "np_": float(v_all[i, 3])}
                pts.setdefault(int(s), {})[port] = (ce_all[i], vals)
        # carry the last filt row (always in the emit set)
        last = filt_at(n_f - 1)
        if last is not None:
            ctx.filt_carry[port] = last

    def _finalize(self, cells: List[TrackedCell]) -> None:
        """Consume finalized symbols in order: sync/CRS measurement
        updates, PBCH collection and the batched MIB decode."""
        for cell in cells:
            ctx = self.ctx.get(_key(cell))
            if ctx is None:
                continue
            n_ports = cell.n_ports
            horizon = min(ctx.horizon[:n_ports]) if n_ports else -1
            obs = self.ce_observer
            while ctx.pending and ctx.pending[0][0] < horizon:
                seq, slot_num, sym_num, syms = ctx.pending.popleft()
                pt = ctx.interp_points.pop(seq, None)
                if obs is not None and pt is not None \
                        and len(pt) == n_ports \
                        and obs[0](slot_num, sym_num):
                    obs[1](cell.n_id_cell, slot_num, sym_num,
                           np.stack([pt[p][0] for p in range(n_ports)]),
                           np.array([pt[p][1]["sp"]
                                     for p in range(n_ports)]),
                           np.array([pt[p][1]["np_"]
                                     for p in range(n_ports)]))
                if slot_num in (0, 10):
                    sv = ctx.sync_vals.pop(seq, None)
                    if sv is not None:
                        self._apply_sync(ctx, sv)
                    if sym_num in (5, 6) and pt is not None \
                            and len(pt) == n_ports:
                        self._crs_update(cell, pt)
                if slot_num == 1 and sym_num <= 3:
                    # syms is None only if an ingest failure left a
                    # placeholder unpatched — drop it rather than feed
                    # the MIB chain a hole.
                    if pt is None or len(pt) < n_ports or syms is None:
                        continue
                    ce = np.stack([pt[p][0] for p in range(n_ports)])
                    np_ = np.array([pt[p][1]["np_"] for p in range(n_ports)])
                    ctx.mib_fifo.append((syms, ce, np_))
        self._dispatch_mib(cells)

    # ------------------------------------------------------------------
    def _apply_sync(self, ctx: _CellCtx, sv) -> None:
        cell = ctx.cell
        _slot, tp, sp, np_e, np_b = sv
        cell.sync_tp, cell.sync_sp = tp, sp
        cell.sync_np, cell.sync_np_blank = np_e, np_b
        if ctx.sync_ce_latest is not None:
            cell.sync_ce = np.concatenate(
                [np.zeros(5), ctx.sync_ce_latest, np.zeros(5)])
        if np.isnan(cell.sync_sp_av):
            cell.sync_tp_av, cell.sync_sp_av = tp, sp
            cell.sync_np_av, cell.sync_np_blank_av = np_e, np_b
        else:
            cell.sync_tp_av = 0.999 * cell.sync_tp_av + 0.001 * tp
            cell.sync_sp_av = 0.999 * cell.sync_sp_av + 0.001 * sp
            cell.sync_np_av = 0.999 * cell.sync_np_av + 0.001 * np_e
            cell.sync_np_blank_av = (0.999 * cell.sync_np_blank_av
                                     + 0.001 * np_b)

    # ------------------------------------------------------------------
    def _dispatch_mib(self, cells: List[TrackedCell]) -> None:
        """Batched MIB decode: synchronized cells contribute every full
        4-frame window at once; hunting cells slide one frame per round
        (their window depends on the previous round's outcome)."""
        while True:
            jobs = []       # (ctx, cell, window, already_popped)
            for cell in cells:
                ctx = self.ctx.get(_key(cell))
                if ctx is None or cell.kill_me:
                    continue
                if ctx.mib_fifo_synchronized:
                    while len(ctx.mib_fifo) >= 16 and not cell.kill_me:
                        win = [ctx.mib_fifo.popleft() for _ in range(16)]
                        jobs.append((ctx, cell, win, True))
                elif len(ctx.mib_fifo) >= 16:
                    jobs.append((ctx, cell,
                                 [ctx.mib_fifo[i] for i in range(16)],
                                 False))
            if not jobs:
                return
            batch = np.stack([_mib_soft(ctx, cell, win)
                              for ctx, cell, win, _ in jobs]
                             ).astype(np.float32)
            dec = to_host(lte_conv_decode_batch(self._up(batch)))
            again = False
            for (ctx, cell, win, popped), c_est in zip(jobs, dec):
                ok = _mib_check(cell, c_est.astype(np.uint8))
                if popped:          # synchronized-cell window
                    if ok:
                        cell.mib_decode_failures = 0.0
                        cell.mib_decode_successes += 1
                        TRACER.count("engine.mib_decodes")
                    else:
                        cell.mib_decode_failures += 1
                elif ok:            # hunting cell locks on
                    for _ in range(16):
                        ctx.mib_fifo.popleft()
                    ctx.mib_fifo_synchronized = True
                    cell.mib_decode_failures = 0.0
                    cell.mib_decode_successes += 1
                    TRACER.count("engine.mib_decodes")
                    again = True
                else:               # hunting: slide one frame
                    cell.mib_decode_failures += 0.25
                    for _ in range(4):
                        ctx.mib_fifo.popleft()
                    again = True
                if cell.mib_decode_failures >= cell.drop_threshold:
                    cell.kill_me = True
            if not again:
                return

    def _crs_update(self, cell: TrackedCell, pt) -> None:
        tp = np.array([pt[p][1]["tp"] for p in range(cell.n_ports)])
        sp_raw = np.array([pt[p][1]["sp_raw"] for p in range(cell.n_ports)])
        np_ = np.array([pt[p][1]["np_"] for p in range(cell.n_ports)])
        cell.ce = np.stack([pt[p][0] for p in range(cell.n_ports)])
        if cell.crs_tp_av is None:
            cell.crs_tp_av, cell.crs_sp_raw_av, cell.crs_np_av = tp, sp_raw, np_
        else:
            cell.crs_tp_av = 0.999 * cell.crs_tp_av + 0.001 * tp
            cell.crs_sp_raw_av = 0.999 * cell.crs_sp_raw_av + 0.001 * sp_raw
            cell.crs_np_av = 0.999 * cell.crs_np_av + 0.001 * np_


# ----------------------------------------------------------------------
# Device programs.


def _pack(*arrays):
    """Flatten+concatenate device outputs in float16: ONE host fetch per
    program at half the bytes. The quantities here are noise-limited
    estimates — f16's ~1e-3 relative error sits far below the estimation
    noise; the phase-critical accumulations (bulk phase, FOE/TOE blends)
    happen in float64 on host either way.

    Feedback-critical statistics (at very high SNR their estimator noise
    can drop below f16's ~1e-3 floor) are marked by wrapping the tensor in
    ``("f32", a)``: they travel LOSSLESSLY, bit-cast to pairs of f16
    lanes (low half first) inside the same single fetch."""
    parts = []
    for a in arrays:
        if isinstance(a, tuple) and a[0] == "f32":
            parts.append(a[1].to(torch.float32).contiguous()
                         .view(torch.float16).reshape(-1))
        else:
            parts.append(a.to(torch.float16).reshape(-1))
    return torch.cat(parts)


def _unpack(flat16: np.ndarray, shapes):
    """Invert _pack on the fetched float16 array. Entries of ``shapes``
    are plain shape tuples (f16) or ("f32", shape) for the losslessly
    packed arrays."""
    out, off = [], 0
    for sh in shapes:
        if isinstance(sh, tuple) and len(sh) and sh[0] == "f32":
            sh = sh[1]
            n = int(np.prod(sh))
            raw = np.ascontiguousarray(flat16[off:off + 2 * n])
            out.append(raw.view(np.float32).astype(np.float64).reshape(sh))
            off += 2 * n
        else:
            n = int(np.prod(sh))
            out.append(flat16[off:off + n].astype(np.float64).reshape(sh))
            off += n
    return out


def demod_shapes(C: int, Q: int, K: int) -> list:
    """The :func:`_unpack` shapes of the demod program's packed results
    (C cells, Q PBCH symbols, K sync pairs each): the PBCH symbols, the
    sync TP, SP, NP and blank-NP, the latest pair's smoothed sync CE."""
    return [(C, Q, 72, 2), (C, K), (C, K), (C, K), (C, K), (C, 62, 2)]


def stats_shapes(T: int, E: int, C: int, P: int) -> list:
    """The :func:`_unpack` shapes of the stats program's packed results
    (T triples, E emit rows, C cells of P ports): the FOE angle and NP,
    the TOE delay and NP (lossless), the emit rows' filtered CE and
    scalars, the per-cell AC sums and weights (lossless; row C is the pad
    segment), the carry rows and the ac_td correlations."""
    return [("f32", (T,)), ("f32", (T,)), ("f32", (T,)), ("f32", (T,)),
            (E, 12, 2), (E, 4), ("f32", (C + 1, 12, 2)),
            ("f32", (C + 1, 12)), (C, P, 2, 12, 2), (C * P, 72, 2)]


def _dequant_plan(bpo, late):
    """The demod plan's link-quantized lanes back to f32: the wrapped bulk
    phase as i16 turn fractions (2pi/65536 ~ 1e-4 rad, exact modular
    wraparound), the fractional lateness as i16 2^-13-sample fixed point;
    f32 inputs pass through unchanged."""
    if bpo.dtype == torch.int16:
        bpo = bpo.to(torch.float32) * float(np.float32(2.0 * np.pi / 65536.0))
    if late.dtype == torch.int16:
        late = late.to(torch.float32) * float(np.float32(1.0 / 8192.0))
    return bpo, late


def _demod_stream(seg_u8, starts, foc_rate, bpo, late, rs_conj_tab,
                  shift_tab, rs_idx, rs_slot, rs_sym, keep_idx, pair_idx,
                  pair_sel, pss_conj, sss_tab):
    """Demod program: every cell's windows demodulated straight from the
    uploaded raw u8 stream by the ``fd_demod_stream`` kernel (starts
    (C, S) relative to seg), then the raw CE at the RS rows and the sync
    measurements. Returns (packed f16 results, raw CE (C, R, P, 12, 2))."""
    bpo, late = _dequant_plan(bpo, late)
    C, S = starts.shape
    syms = fd_demod_stream(seg_u8, starts.reshape(-1),
                           foc_rate.reshape(-1), bpo.reshape(-1),
                           late.reshape(-1)).view(C, S, 72, 2)
    return _demod_tail(syms, rs_conj_tab, shift_tab, rs_idx, rs_slot,
                       rs_sym, keep_idx, pair_idx, pair_sel, pss_conj,
                       sss_tab)


def _demod_samples(data_u8, *plan):
    """Demod program on windows that came with their samples: data (C, S,
    128, 2) u8, the rest :func:`_demod_stream`'s. The windows lie end to
    end as one segment, window k at sample 128 k: every start is
    128-aligned, so the ``fd_demod_stream`` kernel's blend reads one row
    (b = 0) and its lanes are the window's samples in order (j = 0..127),
    the JAX engine's _demod_jit on the same windows."""
    C, S = data_u8.shape[:2]
    starts = 128 * torch.arange(C * S, dtype=torch.int32,
                                device=data_u8.device).view(C, S)
    return _demod_stream(data_u8.reshape(C * S * 128, 2), starts, *plan)


def _demod_tail(syms, rs_conj_tab, shift_tab, rs_idx, rs_slot, rs_sym,
                keep_idx, pair_idx, pair_sel, pss_conj, sss_tab):
    C = syms.shape[0]
    cidx = torch.arange(C, device=syms.device)[:, None]
    # PBCH symbols home; everything else consumed on the device.
    kept = syms[cidx, keep_idx]                          # (C, Q, 72, 2)
    # raw CE at RS rows, sequences from the device-resident tables
    syms_rs = syms[cidx, rs_idx]                         # (C, R, 72, 2)
    rs_conj = rs_conj_tab[cidx, rs_slot, rs_sym]         # (C, R, 12, 2)
    shift = shift_tab[cidx, rs_slot, rs_sym]             # (C, R, P)
    ce = bf.raw_ce_batch(syms_rs[:, :, None], rs_conj[:, :, None],
                         shift)                          # (C, R, P, 12, 2)
    # sync-pair measurements
    sss_syms = syms[cidx, pair_idx[:, :, 0]]
    pss_syms = syms[cidx, pair_idx[:, :, 1]]
    sss_seq = sss_tab[cidx, pair_sel]                    # (C, K, 62)
    sync = bf.sync_meas_batch(pss_syms, sss_syms, pss_conj[:, None],
                              sss_seq)
    # latest pair's smoothed CE per cell (display)
    n_pairs = torch.clamp((pair_idx[:, :, 1] > 0).sum(dim=1) - 1, min=0)
    ce_last = sync["ce_smooth"][cidx[:, 0], n_pairs]     # (C, 62, 2)
    flat = _pack(kept, sync["tp"], sync["sp"], sync["np"],
                 sync["np_blank"], ce_last)
    return flat, ce


def _segment_sum(x, seg_id, n_seg: int):
    """Sums of x's rows per segment (ids ``seg_id`` in [0, n_seg), in any
    order), each segment's rows added in their order, as index_add_ does
    on the CPU. On CUDA index_add_ adds with atomics in no fixed order;
    this sum's bits depend only on the segment's rows, whatever the device
    or the other segments of the call (a cycle split over devices).

    Nothing is read back to the host, so a CUDA graph can capture the
    call: the segment lengths are integer counts added on the device
    (exact in any order; bincount would read their maximum back), and
    segment_reduce skips its checks of them (``unsafe``), which would."""
    order = torch.sort(seg_id, stable=True).indices
    lengths = torch.zeros(n_seg, dtype=seg_id.dtype,
                          device=seg_id.device).scatter_add_(
        0, seg_id, torch.ones_like(seg_id))
    return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _stats(ce_dev, carry_vals, tri, pl, seg_id, emit_idx, carry_idx,
           td_rows, td_new, td0_rows, td0_new, td0_sp, td_hist, n_seg):
    """Stats program: CE filter + FOE/TOE/AC statistics of every RS
    triple, the ac_td history update and correlation, and the per-cell AC
    sums. Returns (packed f16 results, the new ac_td history)."""
    rows = torch.cat([carry_vals.reshape(-1, 12, 2),
                      ce_dev.reshape(-1, 12, 2)])
    cp = rows[tri[:, 0]]
    cc = rows[tri[:, 1]]
    cn = rows[tri[:, 2]]
    ce_filt, np_c, tp_c, sp_c, sp_raw = bf.filter_ce_batch(cp, cc, cn, pl)
    foe_comb, foe_np = bf.foe_stats_batch(cp, cn, ce_filt, np_c)
    delay, delay_np = bf.toe_stats_batch(cp, cc, sp_c, np_c, pl)
    ac, ac_np = bf.ac_fd_batch(cc, sp_c, np_c)

    # ac_td over 72 CONSECUTIVE raw-CE rows per (cell, port) (reference:
    # src/tracker_thread.cpp:318-370 do_ac_td). The rolling history
    # td_hist (Cp, 72, 12, 2) is device-resident engine state: each cycle
    # shifts in the segment's newest min(72, n_rs) center rows — td_rows
    # (Cp, 72) right-aligned combined-row indices, td_new (Cp,) the
    # count. The correlation window is planned separately
    # (td0_rows/td0_new/td0_sp): normally the same newest rows, but on
    # the cycle where a cell first accumulates 72 rows it ends exactly at
    # the 72nd row.
    Cp = td_hist.shape[0]
    k = torch.arange(72, device=rows.device)[None, :]   # (1, 72)
    hist_row = torch.arange(Cp, device=rows.device)[:, None]

    def shift_in(rows_idx, n_new):
        seg = rows[rows_idx]                             # (Cp, 72, 12, 2)
        shift_idx = torch.clamp(k + n_new[:, None], 0, 71)
        h_shift = td_hist[hist_row, shift_idx]
        return torch.where((k + n_new[:, None] < 72)[..., None, None],
                           h_shift, seg)

    new_h = shift_in(td_rows, td_new)
    xc_win = shift_in(td0_rows, td0_new)
    last = xc_win[:, 71]
    prod = cmul(cconj(last[:, None]), torch.flip(xc_win, dims=[1]))
    td_xc = torch.mean(prod, dim=2) / torch.clamp(
        sp_c[td0_sp], min=1e-30)[:, None, None]          # (Cp, 72, 2)

    # AC aggregation per cell (diagnostics; weight-summed on the device).
    # Rows with degenerate power (padding, all-zero windows) produce
    # non-finite ac values — zero-weight them instead of poisoning the
    # per-cell sum with NaN.
    w = 1.0 / torch.clamp(ac_np, min=1e-30)
    finite = torch.isfinite(ac).all(dim=-1) & torch.isfinite(w)
    w = torch.where(finite, w, 0.0)
    ac = torch.where(finite[..., None], ac, 0.0)
    ac_sum = _segment_sum(ac * w[..., None], seg_id, n_seg)
    acw_sum = _segment_sum(w, seg_id, n_seg)

    # Emit rows (brackets the host interpolation needs) + raw carry rows.
    scal = torch.stack([tp_c, sp_c, sp_raw, np_c], dim=-1)  # (T, 4)
    ce_filt_e = ce_filt[emit_idx]                          # (E, 12, 2)
    scal_e = scal[emit_idx]                                # (E, 4)
    carry_out = rows[carry_idx]                            # (C, P, 2, 12, 2)

    # ac_sum/acw_sum travel losslessly: at very high SNR the 1/ac_np
    # weights exceed the f16 max (65504). The FOE feedback consumes only
    # the ANGLE of the combined estimate.
    foe_ang = torch.atan2(foe_comb[:, 1], foe_comb[:, 0])
    return _pack(("f32", foe_ang), ("f32", foe_np),
                 ("f32", delay), ("f32", delay_np),
                 ce_filt_e, scal_e, ("f32", ac_sum), ("f32", acw_sum),
                 carry_out, td_xc), new_h


_PROGRAMS = {"_demod_stream": _demod_stream,
             "_demod_samples": _demod_samples, "_stats": _stats}


def _program(name: str, args: tuple, graphs=None):
    """Run the engine's device program ``name`` (:data:`_PROGRAMS`) on
    ``args``: from the cycle's :class:`_CycleGraphs` ``graphs`` (a replay
    of its CUDA graph, or on a bucket's first cycle an eager run and the
    capture), else eagerly. The one door through which the engine runs
    its programs, so that a tap wrapping it (tools/bench_tracker.py's
    ``ProgramTap``, parallel/multichip_checks.py's ``tracker_cycle``) sees
    every cycle's arguments and results however they ran."""
    if graphs is not None:
        return graphs.run(name, args)
    if args[0].device.type == "cuda":
        TRACER.count("engine.eager_programs")
    return _PROGRAMS[name](*args)


# ----------------------------------------------------------------------
# The cycle's one upload, and the programs' CUDA graphs.


_TORCH_DTYPES = {np.dtype(t): getattr(torch, t) for t in (
    "float32", "int16", "int32", "int64", "uint8", "bool")}


def _layout(arrays) -> tuple:
    """Byte offsets of ``arrays`` laid one after another in one buffer,
    each at a multiple of 16 bytes, and the buffer's size."""
    offsets, n = [], 0
    for a in arrays:
        offsets.append(n)
        n += -(-a.nbytes // 16) * 16
    return offsets, n


def _write(buf: np.ndarray, arrays, offsets) -> None:
    """Copy ``arrays`` into the uint8 buffer ``buf`` at ``offsets``."""
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)


def _views(buf: torch.Tensor, arrays, offsets) -> list:
    """Tensors over the uint8 tensor ``buf`` with the dtypes and shapes of
    ``arrays`` at ``offsets``: what :func:`_write` wrote there."""
    return [buf[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
            for a, o in zip(arrays, offsets)]


class _GraphCache:
    """The engine's CUDA graphs on its card: one :class:`_CycleGraphs` per
    shape key (the names, shapes and dtypes of a cycle's plan arrays: the
    cell and port counts and the bucketed sizes), at most
    :data:`_GRAPH_KEYS`, the least recently used dropped first. Every
    capture allocates from one memory pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.entries: "OrderedDict[tuple, _CycleGraphs]" = OrderedDict()
        self.pool = None

    def entry(self, key: tuple, nbytes: int, tables, td):
        """The graphs of ``key``, made on first use for a plan of
        ``nbytes`` bytes, copies of ``tables`` and an ac_td history like
        ``td`` (None: the cycle runs no stats program)."""
        got = self.entries.get(key)
        if got is not None:
            self.entries.move_to_end(key)
            return got
        got = self.entries[key] = _CycleGraphs(self, nbytes, tables, td)
        while len(self.entries) > _GRAPH_KEYS:
            self.entries.popitem(last=False)
        return got

    def capture(self, name: str, args: tuple) -> tuple:
        """Program ``name`` on ``args`` captured in a CUDA graph: (graph,
        its static outputs, the kernel launches the capture recorded).
        The capture launches nothing on the card, so its wrapper calls
        leave :data:`kernels.LAUNCHES` as it was; each replay adds them."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with launch_device(self.device), torch.cuda.graph(graph,
                                                          pool=self.pool):
            out = _PROGRAMS[name](*args)
        launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                    if n != before[k]}
        kernels.LAUNCHES.update(before)
        TRACER.count("engine.graph_captures")
        return graph, out, launched


class _CycleGraphs:
    """One shape key's device buffers and graphs: the plan's static
    buffer (the cycle's upload lands there, and the programs read views
    of it), the engine's tables and ac_td history as the graphs read them
    (:meth:`load`), and a CUDA graph per program, captured on the key's
    first cycle after an eager run that serves that cycle and warms the
    capture up (:meth:`run`)."""

    def __init__(self, cache: _GraphCache, nbytes: int, tables, td):
        self.cache = cache
        self.plan = torch.empty(nbytes, dtype=torch.uint8,
                                device=cache.device)
        self.tables = tuple(torch.empty_like(t) for t in tables)
        self.tables_of = None
        self.td = None if td is None else torch.empty_like(td)
        self.graphs: Dict[str, tuple] = {}

    def load(self, tables, td) -> None:
        """Copy the engine's tables (when they changed since the last
        load) and its ac_td history ``td`` into the buffers the graphs
        read."""
        if self.tables_of is not tables:
            for dst, src in zip(self.tables, tables):
                dst.copy_(src)
            self.tables_of = tables
        if td is not None:
            self.td.copy_(td)

    def run(self, name: str, args: tuple):
        """Program ``name``'s results: its graph replayed (``args`` are
        then the views the capture read), else an eager run on ``args``
        and the capture."""
        got = self.graphs.get(name)
        if got is not None:
            graph, out, launched = got
            with launch_device(self.cache.device):
                graph.replay()
            for k, n in launched.items():
                kernels.LAUNCHES[k] += n
            TRACER.count("engine.graph_replays")
            return out
        out = _PROGRAMS[name](*args)
        TRACER.count("engine.eager_programs")
        if name == "_stats":
            # The stats graph reads the demod graph's CE rows.
            args = (self.graphs["_demod_stream"][1][1],) + tuple(args[1:])
        self.graphs[name] = self.cache.capture(name, args)
        return out


# ----------------------------------------------------------------------
# Host helpers (the reference tracker thread's math).


@functools.lru_cache(maxsize=8)
def _interp72_mat(shift: int) -> np.ndarray:
    """(72, 12) matrix form of the comb->full-band linear interpolation
    (with linear extrapolation at the edges)."""
    x = np.arange(shift, 72, 6, dtype=float)
    xi = np.arange(72, dtype=float)
    idx = np.clip(np.searchsorted(x, xi, side="right") - 1, 0, 10)
    frac = (xi - x[idx]) / 6.0
    m = np.zeros((72, 12))
    m[np.arange(72), idx] = 1.0 - frac
    m[np.arange(72), idx + 1] += frac
    return m


@functools.lru_cache(maxsize=256)
def _a_value(cp_type: str, port: int, prev_sym_num: int,
             steps: int) -> float:
    """Interpolation fraction for a symbol `steps` positions after the
    previous filtered-CE symbol (time_offset / time_diff, reference
    tracker_thread.cpp:372-477)."""
    n_symb_dl = 7 if cp_type == "normal" else 6
    if port > 2:
        time_diff = 0.0005
    elif cp_type == "extended":
        time_diff = 3 * (128 + 32) / (FS_LTE / 16)
    elif prev_sym_num == 0:
        time_diff = 4 * (128 + 9) / (FS_LTE / 16)
    else:
        time_diff = (2 * (128 + 9) + (128 + 10)) / (FS_LTE / 16)
    time_offset = 0.0
    sym = prev_sym_num
    for _ in range(steps):
        if cp_type == "extended":
            time_offset += (128 + 32) / (FS_LTE / 16)
        else:
            time_offset += ((128 + 10) if sym == 6 else (128 + 9)) \
                / (FS_LTE / 16)
        sym = (sym + 1) % n_symb_dl
    return time_offset / time_diff


def _mib_soft(ctx: _CellCtx, cell: TrackedCell, win) -> np.ndarray:
    """SFBC compensation + soft demod + descramble + deratematch for one
    16-PDU window (everything of the reference's MIB decode up to the
    Viterbi, which runs batched on the device)."""
    n_syms = 960 if cell.cp_type == "normal" else 864
    v_shift_m3 = cell.n_id_cell % 3
    sc = np.arange(72)
    pbch_sym = np.empty(n_syms, dtype=complex)
    pbch_ce = np.empty((cell.n_ports, n_syms), dtype=complex)
    np_pre = np.empty((cell.n_ports, n_syms))
    idx = 0
    for fr in range(4):
        for symn in range(4):
            rs_here = symn in (0, 1) or (symn == 3
                                         and cell.cp_type == "extended")
            mask = ~((sc % 3 == v_shift_m3) & rs_here)
            syms, ce, np_ = win[fr * 4 + symn]
            cnt = int(mask.sum())
            pbch_sym[idx:idx + cnt] = syms[mask]
            pbch_ce[:, idx:idx + cnt] = ce[:cell.n_ports][:, mask]
            np_pre[:, idx:idx + cnt] = np_[:cell.n_ports, None]
            idx += cnt

    if cell.n_ports == 1:
        h = pbch_ce[0]
        gain = np.conj(h) / (np.abs(h) ** 2)
        syms_mib = pbch_sym * gain
        np_mib = np_pre[0] * np.abs(gain) ** 2
    else:
        x1, x2 = pbch_sym[0::2], pbch_sym[1::2]
        if cell.n_ports == 2:
            h1 = 0.5 * (pbch_ce[0, 0::2] + pbch_ce[0, 1::2])
            h2 = 0.5 * (pbch_ce[1, 0::2] + pbch_ce[1, 1::2])
            np_t = 0.5 * (np_pre[0, 0::2] + np_pre[1, 0::2])
        else:
            pairs = n_syms // 2
            use_a = (np.arange(pairs) % 2) == 0
            h1 = np.where(use_a,
                          0.5 * (pbch_ce[0, 0::2] + pbch_ce[0, 1::2]),
                          0.5 * (pbch_ce[1, 0::2] + pbch_ce[1, 1::2]))
            h2 = np.where(use_a,
                          0.5 * (pbch_ce[2, 0::2] + pbch_ce[2, 1::2]),
                          0.5 * (pbch_ce[3, 0::2] + pbch_ce[3, 1::2]))
            np_t = np.where(use_a,
                            0.5 * (np_pre[0, 0::2] + np_pre[2, 0::2]),
                            0.5 * (np_pre[1, 0::2] + np_pre[3, 0::2]))
        scale = np.abs(h1) ** 2 + np.abs(h2) ** 2
        s1 = (np.conj(h1) * x1 + h2 * np.conj(x2)) / scale
        s2 = np.conj((-np.conj(h2) * x1 + h1 * np.conj(x2)) / scale)
        syms_mib = np.empty(n_syms, dtype=complex)
        syms_mib[0::2], syms_mib[1::2] = s1, s2
        syms_mib *= np.sqrt(2.0)
        np_pair = ((np.abs(h1) / scale) ** 2
                   + (np.abs(h2) / scale) ** 2) * np_t
        np_mib = np.repeat(np_pair, 2)

    e_est = lte_demodulate(syms_mib, np_mib, "qpsk")
    e_est = np.where(ctx.scr == 1, -e_est, e_est)
    return lte_conv_deratematch(e_est, 40)


def _mib_check(cell: TrackedCell, c_est: np.ndarray) -> bool:
    crc_est = lte_calc_crc(c_est[:24], "crc16")
    if cell.n_ports == 2:
        crc_est = 1 - crc_est
    elif cell.n_ports == 4:
        crc_est = crc_est.copy()
        crc_est[1::2] = 1 - crc_est[1::2]
    if not np.array_equal(crc_est, c_est[24:]):
        return False
    bw = int(c_est[0]) * 4 + int(c_est[1]) * 2 + int(c_est[2])
    if N_RB_DL_TABLE.get(bw, -1) != cell.n_rb_dl:
        return False
    dur = "extended" if c_est[3] else "normal"
    if dur != cell.phich_duration:
        return False
    return PHICH_RES_TABLE[int(c_est[4]) * 2 + int(c_est[5])] \
        == cell.phich_resource
