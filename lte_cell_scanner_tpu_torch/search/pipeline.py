"""Pipelined fc sweep: the batched cell search as a software pipeline over
chunks of ``batch`` captures.

Counterpart of lte_cell_scanner_tpu/search/pipeline.py, with its stages
and its 4-deep schedule: each chunk goes scan -> tables -> sync dispatch
and collect -> MIB -> collect, one chunk apart. The reference's outer loop is serial per carrier
(src/CellSearch.cpp:471-569); here the host plans one chunk's decode in
float64 while the card runs the next chunk's work:

- the capture stack sits in pinned host memory, and chunk i+1 is copied
  up on a side stream while chunk i scans on the compute stream (an
  event orders the two; ``record_stream`` keeps the upload's memory alive
  for the compute stream);
- the scan's peak tables and the sync and MIB outputs are copied down
  into pinned memory without blocking, each with an event
  (:class:`~lte_cell_scanner_tpu_torch.utils.device.HostFetch`), and are
  collected one chunk later; the decode plans go up without blocking
  (:class:`~lte_cell_scanner_tpu_torch.parallel.fc_sweep.StackDecode`);
- a short last chunk runs as it is;
- over a :class:`~lte_cell_scanner_tpu_torch.parallel.fc_sweep.CapMesh`,
  each chunk splits into runs of batch / n consecutive captures, one per
  shard, each with its own upload stream, scan launch, fetches and
  decode; every stage is dispatched on every shard before any shard's
  result is read.

The kernels and plans are those of
parallel/fc_sweep.py::sharded_search_sweep, so the results are equal cell
for cell; only the schedule differs. The JAX pipeline's workarounds for its
host link (a capture upload cut in 8 pieces, a pool of fetch threads, the
last chunk padded to one compiled shape) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import THRESH2_N_SIGMA
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (StackDecode,
                                                          device_planes,
                                                          flat_stack,
                                                          scan_shards,
                                                          sweep_devices,
                                                          tables_to_peaks)
from lte_cell_scanner_tpu_torch.search.cell_search import dedup
from lte_cell_scanner_tpu_torch.utils.device import (HostFetch,
                                                     full_f32_matmuls)
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER


@dataclasses.dataclass
class _Part:
    """One shard's run of a chunk's captures on its way through the
    stages."""

    shard: int
    lo: int                 # the part's captures in the chunk
    hi: int
    upload: object = None   # (raw device tensor, event) of the upload
    scan: object = None     # StackScan, until its tables are read
    tables: object = None   # HostFetch of the first pass's peak tables
    flat: object = None     # (n n_cap, 2) f32 capture stack on its device
    decode: object = None   # StackDecode


@dataclasses.dataclass
class _Chunk:
    """One chunk of captures on its way through the stages."""

    lo: int                 # index of the chunk's first capture
    fcs: List[float]
    fcp: List[float]
    parts: List[_Part]


@TRACER.traced("pipe")
def pipelined_search_sweep(capbufs, fc_list: Sequence[float],
                           f_search_set: np.ndarray, device=None,
                           batch: int = 64,
                           fs_programmed: float = 1.92e6,
                           thresh2_n_sigma: Optional[float] = None,
                           dedup_cells: bool = True,
                           fc_prog_list: Optional[Sequence[float]] = None,
                           share_banks: bool = False,
                           interp: str = "freq_time"):
    """Full cell search of a whole fc sweep, pipelined in chunks of
    ``batch`` captures. Same contract and results as
    parallel/fc_sweep.py::sharded_search_sweep; for long sweeps, where one
    whole-stack dispatch would hold every capture on the card and leave
    the card idle while the host plans.

    ``capbufs``: uint8 radio planes (B, 2, n_cap), float planes, or
    complex (B, n_cap). Each stage is a span of the tracer
    (utils/profiling.py), ``pipe.<stage>`` inside ``pipe``
    (tools/profile_pipeline.py reads them). ``device`` as in
    sharded_fc_sweep: the CUDA card by default, or a CapMesh, whose shard
    count must divide ``batch``; a sweep shorter than ``batch`` runs as
    one chunk of its length rounded up to a multiple of the shard count
    (the JAX pipeline's rule), its last shards short or empty.
    """
    if thresh2_n_sigma is None:
        thresh2_n_sigma = THRESH2_N_SIGMA
    devs = sweep_devices(None, device)
    n_shards = len(devs)
    if batch % n_shards:
        raise ValueError(f"batch={batch} not divisible by cap shards "
                         f"{n_shards}")
    full_f32_matmuls()
    capbufs = np.asarray(capbufs)
    if capbufs.ndim == 2:
        capbufs = np.stack([capbufs.real, capbufs.imag],
                           1).astype(np.float32)
    B_tot, _, n_cap = capbufs.shape
    if B_tot == 0:
        return [], []
    if B_tot < batch:
        batch = -(-B_tot // n_shards) * n_shards
    per = batch // n_shards
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    fcp_all = (list(fc_list) if fc_prog_list is None
               else list(fc_prog_list))
    host = torch.from_numpy(np.ascontiguousarray(capbufs))
    if any(d.type == "cuda" for d in devs):
        host = host.pin_memory()
    # One upload stream per shard (shards may share a device).
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devs]
    chunks = []
    for lo in range(0, B_tot, batch):
        n = min(batch, B_tot - lo)
        parts = [_Part(k, k * per, min((k + 1) * per, n))
                 for k in range(n_shards) if k * per < n]
        chunks.append(_Chunk(lo, list(fc_list[lo:lo + n]),
                             fcp_all[lo:lo + n], parts))
    n_chunks = len(chunks)
    per_cap: List[List[Cell]] = [[] for _ in range(B_tot)]

    # Each stage is the tracer's span pipe.<stage>.
    def stage_upload(c: _Chunk):
        """Start each part's copy to its device on its shard's stream."""
        with TRACER.span("pipe.upload"):
            for p in c.parts:
                raw = host[c.lo + p.lo:c.lo + p.hi]
                dev, stream = devs[p.shard], streams[p.shard]
                if stream is None:
                    p.upload = (raw, None)
                    continue
                with torch.cuda.stream(stream):
                    raw = raw.to(dev, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                p.upload = (raw, ev)

    def stage_scan(c: _Chunk):
        with TRACER.span("pipe.scan"):
            caps = []
            for p in c.parts:
                (raw, ev), dev = p.upload, devs[p.shard]
                p.upload = None
                if ev is not None:
                    torch.cuda.current_stream(dev).wait_event(ev)
                    raw.record_stream(torch.cuda.current_stream(dev))
                caps.append(device_planes(raw, dev, non_blocking=True))
            scans = scan_shards(caps, [(p.lo, p.hi) for p in c.parts],
                                c.fcs, c.fcp, f_search_set, fs_programmed,
                                share_banks=share_banks, non_blocking=True)
            for p, cap, sc in zip(c.parts, caps, scans):
                p.scan, p.flat = sc, flat_stack(cap)
                p.tables = HostFetch({"tables": sc.tables})

    def stage_tables(c: _Chunk):
        """Collect the peak tables and plan the candidates (host)."""
        with TRACER.span("pipe.tables"):
            for p in c.parts:
                tables = p.scan.host_tables(p.tables.wait()["tables"])
                p.decode = StackDecode(
                    tables_to_peaks(tables, c.fcs[p.lo:p.hi], f_search_set,
                                    fs_programmed,
                                    fc_prog_list=c.fcp[p.lo:p.hi]),
                    p.flat, n_cap, thresh2_n_sigma, interp)
                p.scan = p.tables = p.flat = None

    def stage_sync_dispatch(c: _Chunk):
        with TRACER.span("pipe.sync_dispatch"):
            for p in c.parts:
                p.decode.dispatch_sync()

    def stage_sync_collect(c: _Chunk):
        with TRACER.span("pipe.sync_collect"):
            for p in c.parts:
                p.decode.collect_sync()

    def stage_mib(c: _Chunk):
        with TRACER.span("pipe.mib_dispatch"):
            for p in c.parts:
                p.decode.dispatch_mib()

    def stage_collect(c: _Chunk):
        with TRACER.span("pipe.mib_collect"):
            for p in c.parts:
                for b, cell in p.decode.collect_mib():
                    per_cap[c.lo + p.lo + b].append(cell)
                p.decode = None

    def live(k: int) -> bool:
        return 0 <= k < n_chunks

    # The schedule of the JAX pipeline: at iteration i the tables of chunk
    # i - 1 land, the sync of chunk i - 2 and the MIB of chunk i - 3 are
    # collected, the next chunk's upload starts, then the decode programs
    # and the next chunk's scan are dispatched.
    stage_upload(chunks[0])
    stage_scan(chunks[0])
    for i in range(n_chunks + 3):
        if live(i - 1):
            stage_tables(chunks[i - 1])
        if live(i - 2):
            stage_sync_collect(chunks[i - 2])
        if live(i - 3):
            stage_collect(chunks[i - 3])
        if live(i + 1):
            stage_upload(chunks[i + 1])
        if live(i - 1):
            stage_sync_dispatch(chunks[i - 1])
        if live(i - 2):
            stage_mib(chunks[i - 2])
        if live(i + 1):
            stage_scan(chunks[i + 1])

    good = [c for cells in per_cap for c in cells]
    return per_cap, (dedup(good) if dedup_cells else good)
