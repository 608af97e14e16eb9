"""Per-stage host wall breakdown of the pipelined fc sweep
(search/pipeline.py::pipelined_search_sweep).

Sweeps ``--carriers`` carriers on the 100 kHz raster from ``--fc``, in
chunks of ``--batch`` captures, with the +-``--ppm`` hypothesis grid. Each
capture is the simulator's (cell 271, normal CP, 50 RB), or with
``--load DIR`` the recordings capbuf_XXXX.it there, in turn; each goes in
as the radio's uint8 I/Q planes (x 0.3, so that the bytes do not clip).
After one warm-up sweep, ``--reps`` sweeps are timed on the host clock,
each ending in a device sync, with the program's tracer on
(utils/profiling.py): the seconds of each of the pipeline's stage spans
(``pipe.upload``, ``pipe.scan``, ``pipe.tables``, ``pipe.sync_dispatch``,
``pipe.sync_collect``, ``pipe.mib_dispatch``, ``pipe.mib_collect``) and
of its host waits on the card (``pipe.wait``, inside the stages that
wait) are summed per sweep. Prints one JSON line: the median wall ms per
carrier and per chunk, each stage's median ms per chunk, and the cells
found.

Usage:
    python -m lte_cell_scanner_tpu_torch.tools.profile_pipeline \\
        [--carriers 128] [--batch 32] [--load DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.io.capture import load_capbuf
from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.search.cell_search import generate_search_sets
from lte_cell_scanner_tpu_torch.search.pipeline import pipelined_search_sweep
from lte_cell_scanner_tpu_torch.utils.device import resolve_device
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

# The simulator's |x| reaches ~2.6: at 0.3 the bytes do not clip.
RADIO_GAIN = 0.3


def radio_planes(capbuf: np.ndarray, gain: float = RADIO_GAIN) -> np.ndarray:
    """A complex capture as the radio's (2, n) uint8 I/Q planes."""
    return iq_to_bytes(gain * np.asarray(capbuf)).reshape(-1, 2).T.copy()


def sweep_inputs(carriers: int, fc0: float, load_dir=None):
    """(uint8 planes (B, 2, n), fc list, fc_programmed list)."""
    fcs = [fc0 + 100e3 * i for i in range(carriers)]
    if load_dir is None:
        one = radio_planes(synthetic_capture(
            n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10.0,
            freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3))
        return np.stack([one] * carriers), fcs, list(fcs)
    caps, fcp = [], []
    for i in range(carriers):
        try:
            cap, prog = load_capbuf(load_dir, i)
        except FileNotFoundError:
            cap, prog = load_capbuf(load_dir, i % max(1, len(caps)))
        caps.append(radio_planes(cap))
        fcp.append(prog)
    return np.stack(caps), fcs, fcp


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--carriers", type=int, default=128)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--fc", type=float, default=739e6)
    p.add_argument("--ppm", type=float, default=100)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--load", default=None, metavar="DIR",
                   help="replay the recordings capbuf_XXXX.it in DIR")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    caps, fcs, fcp = sweep_inputs(args.carriers, args.fc, args.load)
    _, fset = generate_search_sets(args.fc, args.fc, args.ppm)

    def sweep():
        out = pipelined_search_sweep(
            caps, fcs, fset, device=dev, batch=args.batch, fc_prog_list=fcp)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    per_cap, _ = sweep()
    walls, stages = [], []
    was_on = TRACER.on
    TRACER.enable()
    try:
        for _ in range(args.reps):
            TRACER.reset()
            t0 = time.perf_counter()
            sweep()
            walls.append(time.perf_counter() - t0)
            stages.append({k: v["seconds"] for k, v in
                           TRACER.snapshot()["spans"].items()
                           if k.startswith("pipe.")})
    finally:
        TRACER.on = was_on
    n_chunks = -(-args.carriers // args.batch)
    wall = float(np.median(walls))
    res = {
        "metric": "pipelined_sweep_ms_per_carrier",
        "value": wall * 1e3 / args.carriers, "unit": "ms",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "carriers": args.carriers, "batch": args.batch, "chunks": n_chunks,
        "n_f": len(fset),
        "wall_ms_per_chunk": wall * 1e3 / n_chunks,
        "wall_ms_runs": [w * 1e3 for w in walls],
        "stage_ms_per_chunk": {
            k: float(np.median([s.get(k, 0.0) for s in stages])) * 1e3
            / n_chunks for k in sorted({k for s in stages for k in s})},
        "cells": sorted({c.n_id_cell() for cells in per_cap for c in cells}),
        "carriers_with_cells": sum(bool(cells) for cells in per_cap),
        "note": ("host clock, each sweep ending in a device sync; a stage "
                 "that waits for the card carries the wait, which "
                 "pipe.wait also sums"),
    }
    res["stage_ms_accounted_per_chunk"] = sum(
        v for k, v in res["stage_ms_per_chunk"].items() if k != "pipe.wait")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
