"""Tracker capacity benchmark: cells tracked in realtime per card.

The reference tracks ~4 cells x 2 ports in realtime on a dual-core
i7-2640 (doc/LTE-Tracker.html:56-57, BASELINE.md). This benchmark
measures the batched engine (tracker/batch_runtime.py): M tracked cells'
complete per-symbol processing — demod, channel estimation/filtering,
FOE/TOE/AC statistics, sync measurements, PBCH collection and the batched
Viterbi MIB decode with health tracking — driven for a stretch of signal,
reporting how many cells fit in realtime.

The per-cell symbol streams replicate one simulated cell's PDUs (the
arithmetic is identical for any cell content; acquisition is exercised by
the tests, not benchmarked here). Each engine cycle is timed on the host
clock and ends in a device sync; the capacity uses the median cycle.

Usage: python -m lte_cell_scanner_tpu_torch.tools.bench_tracker \
           [--cells 96] [--seconds 1.2] [--chunk-ms 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.tracker.batch_runtime import (
    BatchTrackerEngine)
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell
from lte_cell_scanner_tpu_torch.utils.device import resolve_device

BASELINE_CELLS = 4.0


def _collect_pdus(seconds: float, device):
    """Run the real tracker once to harvest authentic descriptor PDUs
    plus the raw uint8 stream they index into."""
    n_subframes = int(seconds * 1000) + 400
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=4e3, n_subframes=n_subframes,
                            sfn_start=0, seed=5)
    harvested = []
    raw_blocks = []

    trk = LTETracker(739e6, initial_freq_offset=4000.0, engine_every=20,
                     device=device)
    # Tap the feeder: record every PDU pushed to the first tracked cell.
    orig_push = TrackedCell.push_pdu

    def tap(self, pdu):
        harvested.append(copy.copy(pdu))
        orig_push(self, pdu)

    def tapped_source():
        for blk in playback_source(sig):
            raw_blocks.append(blk)
            yield blk

    TrackedCell.push_pdu = tap
    try:
        n_blocks = int(seconds * 1.92e6 / 10000) + 250
        trk.run(tapped_source(), max_blocks=n_blocks)
    finally:
        TrackedCell.push_pdu = orig_push
    if not trk.cells:
        raise RuntimeError("benchmark signal failed to acquire")
    return harvested, raw_blocks, trk.cells[0]


def measure(cells=96, seconds=1.2, chunk_ms=300.0, verbose=True,
            warm_chunks=2, device=None) -> dict:
    """Run the capacity measurement; returns the metric dict (the same
    payload ``main`` prints)."""
    dev = resolve_device(device)
    pdus, raw_blocks, proto = _collect_pdus(seconds, dev)
    n_sym_s = proto.n_symb_dl * 2 * 1000
    pdus = pdus[:int(seconds * n_sym_s)]
    chunk = max(1, int(chunk_ms / 1000 * n_sym_s))
    if len(pdus) <= chunk * (int(warm_chunks) + 1):
        # Never let warm-up consume the whole signal: keep >= 2 timed
        # chunks or the measurement degenerates to 0 s.
        chunk = max(1, len(pdus) // (int(warm_chunks) + 2))

    M = cells
    state = GlobalState(fc_requested=739e6, fc_programmed=739e6,
                        fs_programmed=1.92e6, frequency_offset=4000.0)
    # M replicas of the real tracked cell (distinct serials), so the full
    # locked-tracker path runs: MIB decodes succeed.
    cells = [TrackedCell(
        n_id_cell=proto.n_id_cell, n_ports=proto.n_ports,
        cp_type=proto.cp_type, n_rb_dl=proto.n_rb_dl,
        phich_duration=proto.phich_duration,
        phich_resource=proto.phich_resource,
        frame_timing=proto.frame_timing, serial_num=m,
        drop_threshold=float("inf")) for m in range(M)]
    engine = BatchTrackerEngine(state, device=dev)
    for blk in raw_blocks:
        engine.push_raw(blk)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Warm-up: the MIB backlog walks up over the first cycles.
    warm = max(1, int(warm_chunks)) * chunk
    for c in cells:
        c.fifo.extend(pdus[:warm])
    engine.process_all(cells)
    sync()

    fed = warm
    cycle_walls = []
    # Full chunks only, each cycle timed separately: the capacity uses
    # the median cycle, so one slow cycle poisons one sample.
    while fed + chunk <= len(pdus):
        hi = fed + chunk
        sync()
        t1 = time.perf_counter()
        for c in cells:
            c.fifo.extend(pdus[fed:hi])
        engine.process_all(cells)
        sync()
        cycle_walls.append(time.perf_counter() - t1)
        fed = hi
    if not cycle_walls:
        raise RuntimeError("no timed cycle: raise --seconds")
    wall_med = float(np.median(cycle_walls))

    signal_s = (fed - warm) / n_sym_s
    chunk_s = chunk / n_sym_s
    cells_realtime = M * chunk_s / wall_med
    mibs = sum(c.mib_decode_successes for c in cells)
    if verbose:
        print(f"# {M} cells x {signal_s:.2f}s signal in "
              f"{sum(cycle_walls):.2f}s wall (median cycle "
              f"{wall_med:.3f}s, {mibs} MIB decodes)", flush=True)
    return {
        "metric": "tracker_cells_realtime_per_chip",
        "value": cells_realtime,
        "unit": "cells",
        "vs_baseline": cells_realtime / BASELINE_CELLS,
        "cycle_walls_s": cycle_walls,
        "cells": M,
        "chunk_ms": chunk_s * 1e3,
        "mib_decodes": mibs,
        "min_health": min(c.health for c in cells),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=96)
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--chunk-ms", type=float, default=300.0,
                    help="signal per engine cycle (dispatch cadence)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = measure(args.cells, args.seconds, args.chunk_ms,
                  device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
