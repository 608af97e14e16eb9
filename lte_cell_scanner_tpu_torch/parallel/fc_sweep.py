"""Batched fc sweep on one card: B captures (one per center frequency)
scanned in one launch of the scan kernel, then every candidate of the
sweep decoded in two batched programs (sync and MIB).

Counterpart of lte_cell_scanner_tpu/parallel/fc_sweep.py, on one card:
the carrier loop of the reference (src/CellSearch.cpp:471) becomes the
leading axis of the captures. The JAX package maps its one-capture scan
over the captures of each device (``lax.map``, a per-capture bank row);
here the ``xcorr_fold`` kernel takes the capture axis in its grid
(:func:`~lte_cell_scanner_tpu_torch.ops.xcorr_torch.xcorr_fold_batch`),
each capture with its own fold starts and a bank picked by index, and the
greedy peak search runs over the stack. The host receives the peak tables
(B x 64 x 4 floats) and plans the decode in float64.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import (DS_COMB_ARM, HALF_FRAME,
                                                  PSS_TD_LEN,
                                                  THRESH2_N_SIGMA)
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.ops.mib_torch import (decode_mib_batch,
                                                      finish_mib_batch)
from lte_cell_scanner_tpu_torch.ops.peak_torch import (MAX_PEAKS,
                                                       PEAK_BOUND,
                                                       peak_search_device,
                                                       peaks_to_cells,
                                                       r_th1_normalized)
from lte_cell_scanner_tpu_torch.ops.sync_torch import (finish_sync_batch,
                                                       sss_foe_batch)
from lte_cell_scanner_tpu_torch.ops.xcorr import (fold_start_indices,
                                                  n_comb_sp_for,
                                                  n_comb_xc_for,
                                                  shifted_templates)
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import xcorr_core_batch
from lte_cell_scanner_tpu_torch.search.cell_search import dedup
from lte_cell_scanner_tpu_torch.utils.device import (full_f32_matmuls,
                                                     resolve_device, upload)

_DEV_BANK_CACHE: dict = {}   # sweep key -> (banks, bank_idx) on the device


def _cache_put(cache: dict, key, value, cap: int = 8):
    """Bounded FIFO insert (a sweep's banks are MBs on the device)."""
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _to_complex(capbufs: np.ndarray, b: Optional[int] = None):
    """(B, 2, n) planes (uint8 radio bytes or float) -> complex (B, n)
    (complex input passes through); with ``b``, only that capture."""
    if capbufs.ndim != 3:
        return capbufs if b is None else capbufs[b]
    if b is not None:
        capbufs = capbufs[b:b + 1]
    if capbufs.dtype == np.uint8:
        f = (capbufs.astype(np.float32) - 127.0) / 128.0
    else:
        f = capbufs
    c = f[:, 0] + 1j * f[:, 1]
    return c if b is None else c[0]


def _bank_signature(fc: float, fc_prog: float, f_search_set: np.ndarray,
                    fs_programmed: float, n_comb_xc: int,
                    share_banks: bool = False):
    """What a carrier's bank is built from: its float32 frequency-shifted
    templates and its integer fold misalignments d. Returns (templates,
    d, signature bytes).

    Carriers with byte-identical signatures share one bank. By default the
    signature is exact (templates and d): it merges repeated carriers but
    not a raster sweep, whose templates move by a few ulps per 100 kHz.
    ``share_banks`` drops the template bytes: carriers whose fold offsets
    match (multi-MHz spans of the raster) share their group's first bank,
    whose correlation differs by ~1e-6 relative, far below the detection
    noise; the decode re-derives everything in float64 from the detected
    (ind, freq). A capture's fold starts equal its group's first by
    construction (the signature is d), so they stay its own.
    """
    tpl = shifted_templates(f_search_set, fc, fc_prog,
                            fs_programmed).reshape(-1, PSS_TD_LEN)
    st = fold_start_indices(f_search_set, n_comb_xc, fc, fc_prog,
                            fs_programmed)
    d = (st - np.arange(n_comb_xc)[None, :] * HALF_FRAME).astype(np.int64)
    if share_banks:
        return tpl, d, d.tobytes()
    tpl32 = np.stack([tpl.real, tpl.imag], -1).astype(np.float32)
    return tpl, d, tpl32.tobytes() + d.tobytes()


@functools.lru_cache(maxsize=32)
def _fc_bank(fc: float, fc_prog: float, fset_key: bytes,
             fs_programmed: float) -> np.ndarray:
    """A carrier's (n_f, 3, 2, 137) float32 template planes, those of
    ``scan_plan(...).tpl`` (sweeps revisit carriers)."""
    f_search_set = np.frombuffer(fset_key, dtype=np.float64)
    tpl = shifted_templates(f_search_set, fc, fc_prog, fs_programmed)
    return np.stack([tpl.real, tpl.imag], axis=2).astype(np.float32)


def _device_banks(fc_list, fcp, f_search_set, fs_programmed, n_cap,
                  n_comb_xc, dev, share_banks, non_blocking):
    """The sweep's distinct banks on ``dev`` (n_bank, n_f, 3, 2, 137) and
    each capture's bank index (B,) i32, cached across calls."""
    fset_key = f_search_set.tobytes()
    key = (tuple(fc_list), tuple(fcp), fset_key, fs_programmed, n_cap,
           n_comb_xc, str(dev), share_banks)
    entry = _DEV_BANK_CACHE.get(key)
    if entry is None:
        sig_to_u, uniq = {}, []
        bank_idx = np.zeros(len(fc_list), np.int32)
        for b in range(len(fc_list)):
            _, _, sig = _bank_signature(fc_list[b], fcp[b], f_search_set,
                                        fs_programmed, n_comb_xc,
                                        share_banks)
            u = sig_to_u.get(sig)
            if u is None:
                u = sig_to_u[sig] = len(uniq)
                uniq.append(_fc_bank(fc_list[b], fcp[b], fset_key,
                                     fs_programmed))
            bank_idx[b] = u
        entry = (upload(np.stack(uniq), dev, non_blocking),
                 upload(bank_idx, dev, non_blocking))
        _cache_put(_DEV_BANK_CACHE, key, entry)
    return entry


def _sweep_device(capbufs, device) -> torch.device:
    """The card by default; a tensor's own device when one is given."""
    if device is None and isinstance(capbufs, torch.Tensor):
        return capbufs.device
    return resolve_device(device)


def device_planes(capbufs, dev: torch.device,
                  non_blocking: bool = False) -> torch.Tensor:
    """(B, 2, n) float32 re/im planes on ``dev`` from complex (B, n),
    uint8 radio planes (B, 2, n) (converted on the device as
    (x - 127) / 128), float planes, or a tensor of either."""
    if isinstance(capbufs, torch.Tensor):
        x = capbufs.to(dev, non_blocking=non_blocking)
    else:
        a = np.asarray(capbufs)
        if a.ndim == 2:
            a = np.stack([a.real, a.imag], 1).astype(np.float32)
        x = upload(a, dev, non_blocking)
    if x.dtype == torch.uint8:
        return (x.to(torch.float32) - 127.0) / 128.0
    return x.to(torch.float32).contiguous()


def sharded_fc_sweep(capbufs, fc_list: Sequence[float],
                     f_search_set: np.ndarray, device=None,
                     fs_programmed: float = 1.92e6,
                     ds_comb_arm: int = DS_COMB_ARM,
                     max_peaks: int = MAX_PEAKS,
                     fc_prog_list: Optional[Sequence[float]] = None,
                     share_banks: bool = False) -> List[List[Cell]]:
    """Scan B captures, one per center frequency, in one launch of the scan
    kernel. Returns the candidate peak list of each capture.

    ``capbufs``: complex (B, n), uint8 radio planes (B, 2, n) (converted on
    the device), or a float32 (B, 2, n) tensor already on the card (the
    wideband channelizer's output). ``fc_prog_list`` carries the tuner's
    programmed carriers (default: fc_list); the k_factor arithmetic uses
    them as the per-capture path does. ``device=None`` runs on the CUDA
    card (or a tensor's own device) and raises without one;
    ``device="cpu"`` runs the plain versions. ``max_peaks`` is the first
    pass's table size (:meth:`StackScan.host_tables`).

    The fold count is uniform over the stack: the minimum over the
    carriers, which sets the threshold and every capture's fold starts.
    Each capture gets its carrier's template bank; carriers with the same
    bank signature share one upload (:func:`_bank_signature`).
    """
    dev = _sweep_device(capbufs, device)
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    scan = scan_stack(device_planes(capbufs, dev), list(fc_list), fcp,
                      f_search_set, fs_programmed, ds_comb_arm, max_peaks,
                      share_banks)
    return tables_to_peaks(scan.host_tables(), fc_list, f_search_set,
                           fs_programmed, fc_prog_list=fcp)


def scan_inputs(fc_list, fcp, f_search_set, fs_programmed, n_cap, dev,
                share_banks=False, non_blocking=False):
    """The batched scan's inputs on ``dev``: (banks (n_bank, n_f, 3, 2,
    137), bank_idx (B,) i32, starts (B, n_f, n_comb_xc) i32, n_comb_xc,
    n_comb_sp). n_comb_xc is the minimum over the carriers."""
    B = len(fc_list)
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = min(n_comb_xc_for(n_lags, f_search_set, fc_list[b], fcp[b],
                                  fs_programmed) for b in range(B))
    starts = np.stack([fold_start_indices(f_search_set, n_comb_xc,
                                          fc_list[b], fcp[b], fs_programmed)
                       for b in range(B)]).astype(np.int32)
    banks, bank_idx = _device_banks(fc_list, fcp, f_search_set,
                                    fs_programmed, n_cap, n_comb_xc, dev,
                                    share_banks, non_blocking)
    return (banks, bank_idx, upload(starts, dev, non_blocking), n_comb_xc,
            n_comb_sp_for(n_cap))


@dataclasses.dataclass
class StackScan:
    """A capture stack's scan on its device: the first pass's peak tables
    (B, max_peaks, 4) and the scan tables a full one is redone from."""

    tables: torch.Tensor
    packed: torch.Tensor     # (B, 7, 9600)
    single: torch.Tensor     # (B, 3, 9600, n_f)
    r_norm: float
    ds_comb_arm: int

    def host_tables(self, tables: Optional[np.ndarray] = None
                    ) -> List[np.ndarray]:
        """Each capture's peak table on the host (``tables``: the first
        pass's, already copied down). The first pass runs a fixed trip
        count and never waits for the card, so it may cut a dense capture
        short; a full table is redone on the scan's device by the greedy
        loop at PEAK_BOUND trips, the unbounded search (reference peak
        loop src/CellSearch.cpp:471-569)."""
        if tables is None:
            tables = self.tables.cpu().numpy()
        out = list(tables)
        full = np.flatnonzero(tables[:, -1, 0] > 0.0)
        if len(full) and tables.shape[1] < PEAK_BOUND:
            idx = torch.from_numpy(full).to(self.packed.device)
            redo = peak_search_device(self.packed[idx], self.single[idx],
                                      self.r_norm, self.ds_comb_arm,
                                      max_peaks=PEAK_BOUND).cpu().numpy()
            for k, b in enumerate(full):
                out[b] = redo[k]
        return out


def scan_stack(cap: torch.Tensor, fc_list, fcp, f_search_set,
               fs_programmed, ds_comb_arm=DS_COMB_ARM, max_peaks=MAX_PEAKS,
               share_banks=False, non_blocking=False) -> StackScan:
    """Scan and first-pass peak tables of the (B, 2, n) float32 stack on
    its device. The peak loop runs its full trip count and never waits
    for the card."""
    banks, bank_idx, starts, n_comb_xc, n_comb_sp = scan_inputs(
        fc_list, fcp, f_search_set, fs_programmed, cap.shape[2], cap.device,
        share_banks, non_blocking)
    packed, single = xcorr_core_batch(cap, banks, bank_idx, starts,
                                      n_comb_xc, n_comb_sp, ds_comb_arm)
    r_norm = r_th1_normalized(n_comb_xc, ds_comb_arm)
    tables = peak_search_device(packed, single, r_norm, ds_comb_arm,
                                max_peaks=max_peaks, early_exit=False)
    return StackScan(tables, packed, single, r_norm, ds_comb_arm)


def tables_to_peaks(tables: Sequence[np.ndarray], fc_list: Sequence[float],
                    f_search_set: np.ndarray, fs_programmed: float = 1.92e6,
                    fc_prog_list: Optional[Sequence[float]] = None
                    ) -> List[List[Cell]]:
    """Host tail of the batched scan: each capture's peak table (from
    :meth:`StackScan.host_tables`) -> its Cell candidates."""
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    return [peaks_to_cells(tables[b], f_search_set, fc, fcp[b],
                           fs_programmed) for b, fc in enumerate(fc_list)]


def flat_stack(cap: torch.Tensor) -> torch.Tensor:
    """(B, 2, n) planes -> the (B n, 2) stack the decode programs read."""
    return cap.transpose(1, 2).reshape(-1, 2)


class StackDecode:
    """The decode of every candidate of a capture stack, in four stages:
    one sync program over all candidates, then one MIB program per CP
    type; each candidate reads its own capture at its base (b * n_cap) in
    the flat stack. Each program's results come down without blocking, so
    a pipeline collects them a chunk later; the whole-stack sweep runs the
    stages back to back."""

    def __init__(self, peaks: List[List[Cell]], flat: torch.Tensor,
                 n_cap: int, thresh2_n_sigma: float, interp: str):
        self.cells = [c for p in peaks for c in p]
        self.bases = [b * n_cap for b, p in enumerate(peaks) for _ in p]
        self.flat, self.n_cap = flat, n_cap
        self.thresh2_n_sigma, self.interp = thresh2_n_sigma, interp
        self.sync = self.mib = None

    def dispatch_sync(self):
        self.sync = sss_foe_batch(self.cells, self.flat,
                                  self.thresh2_n_sigma, n_cap=self.n_cap,
                                  cap_bases=self.bases, defer=True)

    def collect_sync(self):
        self.sync = finish_sync_batch(self.sync)

    def dispatch_mib(self):
        """One MIB program per CP type over the candidates that synced;
        the capture stack is no longer needed after it."""
        alive = [(c, base) for c, base in zip(self.sync, self.bases)
                 if c.n_id_1 >= 0]
        self.sync, self.mib = None, []
        for cp in ("normal", "extended"):
            grp = [(c, base) for c, base in alive if c.cp_type == cp]
            if grp:
                bases = [base for _, base in grp]
                self.mib.append((decode_mib_batch(
                    [c for c, _ in grp], self.flat, interp=self.interp,
                    n_cap=self.n_cap, cap_bases=bases, defer=True), bases))
        self.flat = None

    def collect_mib(self) -> List[Tuple[int, Cell]]:
        """The decoded cells, each with its capture's index in the stack."""
        out = [(base // self.n_cap, c) for pending, bases in self.mib
               for c, base in zip(finish_mib_batch(pending), bases)
               if c.n_rb_dl >= 0]
        self.mib = None
        return out


def sharded_search_sweep(capbufs, fc_list: Sequence[float],
                         f_search_set: np.ndarray, device=None,
                         fs_programmed: float = 1.92e6,
                         thresh2_n_sigma: Optional[float] = None,
                         dedup_cells: bool = True,
                         fc_prog_list: Optional[Sequence[float]] = None,
                         share_banks: bool = False,
                         interp: str = "freq_time"):
    """Full cell search of a whole fc sweep: the batched scan, then every
    candidate of the sweep decoded in two batched programs over one stack
    of the captures (:class:`StackDecode`).

    Returns (cells_per_capture, deduped): ``deduped`` merges across the
    sweep like src/CellSearch.cpp:285-319. ``interp`` is the MIB chain's
    channel-estimate interpolator ("freq_time", the JAX sweep's, or
    "hex"). ``device`` as in :func:`sharded_fc_sweep`.
    """
    if thresh2_n_sigma is None:
        thresh2_n_sigma = THRESH2_N_SIGMA
    dev = _sweep_device(capbufs, device)
    full_f32_matmuls()
    cap = device_planes(capbufs, dev)
    B, _, n_cap = cap.shape
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    scan = scan_stack(cap, list(fc_list), fcp, f_search_set, fs_programmed,
                      share_banks=share_banks)
    peaks = tables_to_peaks(scan.host_tables(), fc_list, f_search_set,
                            fs_programmed, fc_prog_list=fcp)
    del scan
    dec = StackDecode(peaks, flat_stack(cap), n_cap, thresh2_n_sigma,
                      interp)
    dec.dispatch_sync()
    dec.collect_sync()
    dec.dispatch_mib()
    per_cap: List[List[Cell]] = [[] for _ in range(B)]
    good = []
    for b, c in dec.collect_mib():
        per_cap[b].append(c)
        good.append(c)
    return per_cap, (dedup(good) if dedup_cells else good)
