"""Batched fc sweep: B captures (one per center frequency) scanned in one
launch of the scan kernel per shard, then every candidate of the sweep
decoded in two batched programs (sync and MIB) per shard.

Counterpart of lte_cell_scanner_tpu/parallel/fc_sweep.py: the carrier
loop of the reference (src/CellSearch.cpp:471) becomes the leading axis
of the captures. The JAX package maps its one-capture scan over the
captures of each device (``lax.map``, a per-capture bank row); here the
``xcorr_fold`` kernel takes the capture axis in its grid
(:func:`~lte_cell_scanner_tpu_torch.ops.xcorr_torch.xcorr_fold_batch`),
each capture with its own fold starts and a bank picked by index, and the
greedy peak search runs over the stack. The host receives the peak tables
(B x 64 x 4 floats) and plans the decode in float64.

The JAX ``cap`` mesh axis is a :class:`CapMesh`: shard k takes the k-th
run of B / n consecutive captures onto its own device, with one scan
launch and one decode of its own; every shard's work is dispatched before
any shard's result is read, and the cells are merged in capture order.
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
                                                       peak_search_device,
                                                       peaks_to_cells,
                                                       r_th1_normalized,
                                                       redo_full_tables)
from lte_cell_scanner_tpu_torch.ops.sync_torch import (finish_sync_batch,
                                                       sss_foe_batch)
from lte_cell_scanner_tpu_torch.ops.xcorr import (fold_start_indices,
                                                  n_comb_sp_for,
                                                  n_comb_xc_for,
                                                  shifted_templates)
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import xcorr_core_batch
from lte_cell_scanner_tpu_torch.search.cell_search import dedup
from lte_cell_scanner_tpu_torch.utils.device import (HostFetch,
                                                     full_f32_matmuls,
                                                     resolve_device, upload)

# (sweep, mesh devices, shard bounds) -> [(banks, bank_idx) per shard]
_DEV_BANK_CACHE: dict = {}


class CapMesh:
    """The devices of a sweep's ``cap`` axis, one shard each, in order.

    Shard k takes the k-th run of B / n consecutive captures onto
    ``devices[k]``. Devices may repeat (``("cpu", "cpu")``,
    ``("cuda:0", "cuda:0")``): two shards on one device still split the
    work, with a scan launch and a decode each. A CUDA device raises
    without CUDA."""

    def __init__(self, devices: Sequence):
        if not len(devices):
            raise ValueError("CapMesh: no devices")
        self.devices = tuple(resolve_device(d) for d in devices)

    def __repr__(self) -> str:
        return f"CapMesh({[str(d) for d in self.devices]})"


def make_cap_mesh(n_cap_shards: int) -> CapMesh:
    """A CapMesh of the first ``n_cap_shards`` CUDA devices; raises when
    fewer are visible."""
    n_vis = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 1 <= n_cap_shards <= n_vis:
        raise RuntimeError(f"make_cap_mesh: {n_cap_shards} CUDA device(s) "
                           f"asked for, {n_vis} visible")
    return CapMesh([torch.device("cuda", i) for i in range(n_cap_shards)])


def cap_shards(n_captures: int, n_devices: int) -> int:
    """The largest shard count of at most ``n_devices`` that divides
    ``n_captures`` (the JAX CLI's and wideband sweep's choice,
    search/cli.py:297-309 there)."""
    return max(d for d in range(1, max(1, n_devices) + 1)
               if n_captures % d == 0)


def all_cards_mesh(n_captures: int) -> CapMesh:
    """Every visible card that a sweep of ``n_captures`` divides over:
    :func:`cap_shards` of the CUDA device count. Raises without CUDA."""
    resolve_device(None)
    return make_cap_mesh(cap_shards(n_captures, torch.cuda.device_count()))


def sweep_devices(capbufs, device) -> Tuple[torch.device, ...]:
    """The shards' devices: a CapMesh's, else one shard on ``device``:
    by default the CUDA card, or a tensor's own device."""
    if isinstance(device, CapMesh):
        return device.devices
    if device is None and isinstance(capbufs, torch.Tensor):
        return (capbufs.device,)
    return (resolve_device(device),)


def shard_bounds(n_captures: int, n_shards: int) -> List[Tuple[int, int]]:
    """Each shard's (lo, hi) run of consecutive captures; raises unless
    the shards divide the captures (as the JAX sweep does)."""
    if n_captures % n_shards:
        raise ValueError(f"B={n_captures} not divisible by cap shards "
                         f"{n_shards}")
    per = n_captures // n_shards
    return [(k * per, (k + 1) * per) for k in range(n_shards)]


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
                  n_comb_xc, devs, bounds, share_banks, non_blocking):
    """Each shard's distinct banks on its device (n_bank, n_f, 3, 2, 137)
    and the bank index (hi - lo,) i32 of each of its captures, cached
    across calls in one entry per sweep and mesh (so that the shards of
    one sweep never evict each other's banks)."""
    fset_key = f_search_set.tobytes()
    key = (tuple(fc_list), tuple(fcp), fset_key, fs_programmed, n_cap,
           n_comb_xc, tuple(str(d) for d in devs), tuple(bounds),
           share_banks)
    entry = _DEV_BANK_CACHE.get(key)
    if entry is None:
        entry = []
        for dev, (lo, hi) in zip(devs, bounds):
            sig_to_u, uniq = {}, []
            bank_idx = np.zeros(hi - lo, np.int32)
            for b in range(lo, hi):
                _, _, sig = _bank_signature(fc_list[b], fcp[b], f_search_set,
                                            fs_programmed, n_comb_xc,
                                            share_banks)
                u = sig_to_u.get(sig)
                if u is None:
                    u = sig_to_u[sig] = len(uniq)
                    uniq.append(_fc_bank(fc_list[b], fcp[b], fset_key,
                                         fs_programmed))
                bank_idx[b - lo] = u
            entry.append((upload(np.stack(uniq), dev, non_blocking),
                          upload(bank_idx, dev, non_blocking)))
        _cache_put(_DEV_BANK_CACHE, key, entry)
    return entry


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


def shard_stacks(capbufs, devs, bounds,
                 non_blocking: bool = False) -> List[torch.Tensor]:
    """Each shard's (hi - lo, 2, n) float32 planes on its device
    (:func:`device_planes` of its run of captures)."""
    return [device_planes(capbufs[lo:hi], dev, non_blocking)
            for dev, (lo, hi) in zip(devs, bounds)]


def sharded_fc_sweep(capbufs, fc_list: Sequence[float],
                     f_search_set: np.ndarray, device=None,
                     fs_programmed: float = 1.92e6,
                     ds_comb_arm: int = DS_COMB_ARM,
                     max_peaks: int = MAX_PEAKS,
                     fc_prog_list: Optional[Sequence[float]] = None,
                     share_banks: bool = False) -> List[List[Cell]]:
    """Scan B captures, one per center frequency, in one launch of the scan
    kernel per shard. Returns the candidate peak list of each capture.

    ``capbufs``: complex (B, n), uint8 radio planes (B, 2, n) (converted on
    the device), or a float32 (B, 2, n) tensor already on the card (the
    wideband channelizer's output). ``fc_prog_list`` carries the tuner's
    programmed carriers (default: fc_list); the k_factor arithmetic uses
    them as the per-capture path does. ``device=None`` runs on the CUDA
    card (or a tensor's own device) and raises without one;
    ``device="cpu"`` runs the plain versions; a :class:`CapMesh` splits
    the captures over its shards (B must be a multiple of their count).
    ``max_peaks`` is the first pass's table size
    (:meth:`StackScan.host_tables`).

    The fold count is uniform over the sweep: the minimum over all its
    carriers, which sets the threshold and every capture's fold starts on
    every shard. Each capture gets its carrier's template bank; carriers
    of one shard with the same bank signature share one upload
    (:func:`_bank_signature`).
    """
    devs = sweep_devices(capbufs, device)
    bounds = shard_bounds(len(fc_list), len(devs))
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    scans = scan_shards(shard_stacks(capbufs, devs, bounds), bounds,
                        list(fc_list), fcp, f_search_set, fs_programmed,
                        ds_comb_arm, max_peaks, share_banks)
    tables = [t for shard in shard_tables(scans) for t in shard]
    return tables_to_peaks(tables, fc_list, f_search_set, fs_programmed,
                           fc_prog_list=fcp)


def scan_inputs(fc_list, fcp, f_search_set, fs_programmed, n_cap, dev,
                share_banks=False, non_blocking=False):
    """The batched scan's inputs of one stack on ``dev``: (banks (n_bank,
    n_f, 3, 2, 137), bank_idx (B,) i32, starts (B, n_f, n_comb_xc) i32,
    n_comb_xc, n_comb_sp). n_comb_xc is the minimum over the carriers."""
    (inputs,), n_comb_xc, n_comb_sp = shard_inputs(
        fc_list, fcp, f_search_set, fs_programmed, n_cap, (dev,),
        [(0, len(fc_list))], share_banks, non_blocking)
    return (*inputs, n_comb_xc, n_comb_sp)


def shard_inputs(fc_list, fcp, f_search_set, fs_programmed, n_cap, devs,
                 bounds, share_banks=False, non_blocking=False):
    """The batched scan's inputs of each shard on its device, shard k
    holding captures ``bounds[k]`` of the sweep on ``devs[k]``: ([(banks
    (n_bank, n_f, 3, 2, 137), bank_idx (hi - lo,) i32, starts (hi - lo,
    n_f, n_comb_xc) i32) per shard], n_comb_xc, n_comb_sp). n_comb_xc is
    the minimum over the whole sweep, so that every shard folds the count
    of the one-device scan."""
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = min(n_comb_xc_for(n_lags, f_search_set, fc, fp,
                                  fs_programmed)
                    for fc, fp in zip(fc_list, fcp))
    starts = np.stack([fold_start_indices(f_search_set, n_comb_xc, fc, fp,
                                          fs_programmed)
                       for fc, fp in zip(fc_list, fcp)]).astype(np.int32)
    banks = _device_banks(fc_list, fcp, f_search_set, fs_programmed, n_cap,
                          n_comb_xc, devs, bounds, share_banks, non_blocking)
    return ([(bk, idx, upload(starts[lo:hi], dev, non_blocking))
             for (bk, idx), dev, (lo, hi) in zip(banks, devs, bounds)],
            n_comb_xc, n_comb_sp_for(n_cap))


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
        count and never waits for the card; a full table is redone on the
        scan's device (:func:`~lte_cell_scanner_tpu_torch.ops.peak_torch.
        redo_full_tables`)."""
        if tables is None:
            tables = self.tables.cpu().numpy()
        return redo_full_tables(tables, self.packed, self.single,
                                self.r_norm, self.ds_comb_arm)


def scan_shards(caps: Sequence[torch.Tensor], bounds, fc_list, fcp,
                f_search_set, fs_programmed, ds_comb_arm=DS_COMB_ARM,
                max_peaks=MAX_PEAKS, share_banks=False,
                non_blocking=False) -> List[StackScan]:
    """Scan and first-pass peak tables of each shard's (hi - lo, 2, n)
    float32 stack ``caps[k]`` on its device, captures ``bounds[k]`` of
    the sweep: one scan launch per shard, every shard dispatched before
    any is read. The peak loop runs its full trip count and never waits
    for the card."""
    inputs, n_comb_xc, n_comb_sp = shard_inputs(
        fc_list, fcp, f_search_set, fs_programmed, caps[0].shape[2],
        [c.device for c in caps], bounds, share_banks, non_blocking)
    r_norm = r_th1_normalized(n_comb_xc, ds_comb_arm)
    scans = []
    for cap, (banks, bank_idx, starts) in zip(caps, inputs):
        packed, single = xcorr_core_batch(cap, banks, bank_idx, starts,
                                          n_comb_xc, n_comb_sp, ds_comb_arm)
        tables = peak_search_device(packed, single, r_norm, ds_comb_arm,
                                    max_peaks=max_peaks, early_exit=False)
        scans.append(StackScan(tables, packed, single, r_norm, ds_comb_arm))
    return scans


def shard_tables(scans: Sequence[StackScan]) -> List[List[np.ndarray]]:
    """Each shard's peak tables on the host (:meth:`StackScan.host_tables`):
    every shard's copy is started before any is waited for."""
    fetches = [HostFetch({"tables": sc.tables}) for sc in scans]
    return [sc.host_tables(f.wait()["tables"])
            for sc, f in zip(scans, fetches)]


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
    candidate of each shard decoded in two batched programs over one
    stack of its captures (:class:`StackDecode`).

    Returns (cells_per_capture, deduped): ``deduped`` merges across the
    sweep like src/CellSearch.cpp:285-319. ``interp`` is the MIB chain's
    channel-estimate interpolator ("freq_time", the JAX sweep's, or
    "hex"). ``device`` as in :func:`sharded_fc_sweep`.
    """
    devs = sweep_devices(capbufs, device)
    bounds = shard_bounds(len(fc_list), len(devs))
    return search_shard_stacks(
        shard_stacks(capbufs, devs, bounds), fc_list, f_search_set,
        fs_programmed, thresh2_n_sigma, dedup_cells, fc_prog_list,
        share_banks, interp)


def search_shard_stacks(caps: Sequence[torch.Tensor],
                        fc_list: Sequence[float], f_search_set: np.ndarray,
                        fs_programmed: float = 1.92e6,
                        thresh2_n_sigma: Optional[float] = None,
                        dedup_cells: bool = True,
                        fc_prog_list: Optional[Sequence[float]] = None,
                        share_banks: bool = False,
                        interp: str = "freq_time"):
    """:func:`sharded_search_sweep` of a sweep already split into shard
    stacks: ``caps[k]``, (B / n, 2, n_cap) float32 on shard k's device,
    holds the k-th run of consecutive captures. Every shard's scan is
    dispatched, then every shard's tables read, then every shard's sync
    and MIB programs dispatched before any is collected, so that the
    devices run side by side. The cells are merged in capture order, then
    deduplicated once."""
    if thresh2_n_sigma is None:
        thresh2_n_sigma = THRESH2_N_SIGMA
    full_f32_matmuls()
    n_cap = caps[0].shape[2]
    bounds = shard_bounds(len(fc_list), len(caps))
    fcp = list(fc_list) if fc_prog_list is None else list(fc_prog_list)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    scans = scan_shards(caps, bounds, list(fc_list), fcp, f_search_set,
                        fs_programmed, share_banks=share_banks)
    tables = shard_tables(scans)
    del scans                   # the scan tables go before the decode
    decs = [StackDecode(tables_to_peaks(tab, fc_list[lo:hi], f_search_set,
                                        fs_programmed,
                                        fc_prog_list=fcp[lo:hi]),
                        flat_stack(cap), n_cap, thresh2_n_sigma, interp)
            for tab, cap, (lo, hi) in zip(tables, caps, bounds)]
    for dec in decs:
        dec.dispatch_sync()
    for dec in decs:
        dec.collect_sync()
    for dec in decs:
        dec.dispatch_mib()
    per_cap: List[List[Cell]] = [[] for _ in fc_list]
    for dec, (lo, _) in zip(decs, bounds):
        for b, c in dec.collect_mib():
            per_cap[lo + b].append(c)
    good = [c for cells in per_cap for c in cells]
    return per_cap, (dedup(good) if dedup_cells else good)
