"""Device latency of the batched decode chain, per stage.

Times the sync program (``ops/sync_torch.py::_sync_device``) and the MIB
program (``ops/mib_torch.py::run``) on a batch of ``--batch`` candidates
with CUDA events: warm-up, then the median of ``--iters`` runs. The MIB
program is also cut at each milestone of ``run``'s ``stages=`` hook (tfg,
tfoec, toe, chanest, pbch, llr, vit) by an event recorded there, so the
batch's time is attributed per stage; ``mib_<stage>_ms`` is the time from
the program's start to the milestone, ``mib_<stage>_delta_ms`` the time
since the previous one. The events time the device stream, and the time
between two events includes the host's launch gaps between them. The JAX
tool's "wins" cut has no counterpart: the window gather runs inside the
symbol-demod kernel, before the tfg milestone. ``--stages`` reports a
subset of :data:`STAGES` ("full" is always timed, as the JAX tool times
it first); each delta is then taken from the previous reported stage.

Workload: one 80 ms capture (the simulator's, or ``--capture FILE.it``)
searched on the device (scan, greedy peaks, SSS/FOE); the synced cells of
the strongest cell's CP type, replicated to the MIB batch of 64 candidates
(reference per-candidate chain: src/searcher.cpp:533-1692). ``--b-cap N``
stacks N copies of the capture end to end, as a batched sweep hands the
decode its captures (the JAX tool's ``--b-cap``): candidate i reads copy
i mod N through the plans' capture bases, so the batch of 64 spreads over
the stack (32 copies: 2 candidates each).

Usage:
    python -m lte_cell_scanner_tpu_torch.tools.bench_decode [--iters 20]
        [--batch 64] [--b-cap 32] [--stages full,tfg,vit] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import (DS_COMB_ARM,
                                                  THRESH2_N_SIGMA)
from lte_cell_scanner_tpu_torch.ops import mib_torch, xcorr_torch
from lte_cell_scanner_tpu_torch.ops.peak_torch import (peak_search_device,
                                                       peaks_to_cells,
                                                       r_th1_normalized)
from lte_cell_scanner_tpu_torch.ops.sync_torch import (_sync_device,
                                                       sss_foe_batch,
                                                       sync_plan)
from lte_cell_scanner_tpu_torch.tools.bench_scan import WARMUP, get_capture
from lte_cell_scanner_tpu_torch.utils.device import (full_f32_matmuls,
                                                     resolve_device)

STAGES = ("tfg", "tfoec", "toe", "chanest", "pbch", "llr", "vit", "full")


class _Marks(dict):
    """A ``stages=`` dict that also marks the time each milestone is
    reached: a CUDA event on the card, the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        super().__init__()
        self.dev = dev
        self.times = {}

    def mark(self, name: str) -> None:
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.times[name] = ev
        else:
            self.times[name] = time.perf_counter()

    def __setitem__(self, name, value):
        self.mark(name)
        super().__setitem__(name, value)

    def elapsed_ms(self, name: str) -> float:
        a, b = self.times["start"], self.times[name]
        if self.dev.type == "cuda":
            return a.elapsed_time(b)
        return (b - a) * 1e3


def search_candidates(cap_ri: torch.Tensor, n_cap: int, fc: float):
    """The device search's peaks and synced cells of one capture."""
    fset = np.arange(-15, 16) * 5e3
    plan = xcorr_torch.scan_plan(n_cap, fset, fc, fc, 1.92e6)
    packed, single, _ = xcorr_torch.xcorr_core(cap_ri.T.contiguous(), plan,
                                               DS_COMB_ARM)
    peaks = peaks_to_cells(peak_search_device(
        packed, single, r_th1_normalized(plan.n_comb_xc, DS_COMB_ARM),
        DS_COMB_ARM).cpu().numpy(), fset, fc, fc)
    cells = [c for c in sss_foe_batch(peaks, cap_ri, THRESH2_N_SIGMA)
             if c.n_id_1 >= 0]
    return peaks, cells


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--batch", type=int, default=64,
                   help="candidates in the MIB batch")
    p.add_argument("--b-cap", type=int, default=1,
                   help="captures in the stacked buffer (1: one capture)")
    p.add_argument("--capture", default=None,
                   help=".it file with a capbuf record (default: simulator)")
    p.add_argument("--stages", default=",".join(STAGES),
                   help="comma-separated subset of the MIB milestones")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    wanted = set(args.stages.split(","))
    stages = [st for st in STAGES if st in wanted]

    dev = resolve_device(args.device)
    full_f32_matmuls()
    cap, fc = get_capture(args.capture)
    n_cap = len(cap)
    cap_ri = torch.from_numpy(
        np.stack([cap.real, cap.imag], -1).astype(np.float32)).to(dev)
    peaks, cells = search_candidates(cap_ri, n_cap, fc)
    if not cells:
        raise SystemExit("no synced cells in the capture")
    cp = max(cells, key=lambda c: c.pss_pow).cp_type
    cells = [c for c in cells if c.cp_type == cp]
    reps = -(-args.batch // len(cells))
    cells_b = (cells * reps)[:args.batch]
    peaks_b = (peaks * -(-args.batch // len(peaks)))[:args.batch]
    # Candidate i reads copy i mod b_cap of the stacked capture.
    bases = [(i % args.b_cap) * n_cap for i in range(args.batch)]
    splan = sync_plan(peaks_b, n_cap, bases)
    mplan = mib_torch.mib_plan(cells_b, n_cap, bases)
    stack = cap_ri.repeat(args.b_cap, 1) if args.b_cap > 1 else cap_ri

    def timed(fn):
        """Median ms of each mark of fn(marks) over --iters runs."""
        for _ in range(WARMUP):
            fn(_Marks(dev))
        runs = []
        for _ in range(args.iters):
            marks = _Marks(dev)
            marks.mark("start")
            fn(marks)
            marks.mark("full")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            runs.append({k: marks.elapsed_ms(k) for k in marks.times
                         if k != "start"})
        return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}

    results = {"b_candidates": len(cells_b), "b_captures": args.b_cap,
               "cp_type": cp,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
    results["sync_ms"] = timed(
        lambda m: _sync_device(stack, splan, THRESH2_N_SIGMA))["full"]
    mib = timed(lambda m: mib_torch.run(stack, mplan, "hex", stages=m))
    prev = 0.0
    for st in stages:
        results[f"mib_{st}_ms"] = mib[st]
        results[f"mib_{st}_delta_ms"] = mib[st] - prev
        prev = mib[st]
    decoded = mib_torch.finish_mib_batch(mib_torch.MibPending(
        mib_torch.run(stack, mplan, "hex"), mplan))
    ok = [c.n_rb_dl >= 0 for c in decoded]
    n = len(cells)
    results.update({
        "mib_decoded": sum(ok),
        # Distinct synced candidates, how many of them decode, and whether
        # every replica in the batch decodes as its original does.
        "n_synced": n,
        "synced_decoded": sum(ok[:n]),
        "replicas_agree": all(ok[i] == ok[i % n] for i in range(len(ok))),
        "cells": sorted({c.n_id_cell() for c in decoded if c.n_rb_dl >= 0}),
        "metric": "device_decode_latency_ms",
        "value": mib["full"],
        "unit": "ms",
        "note": ("CUDA events on the device stream; the time between two "
                 "events includes the host's launch gaps"
                 if dev.type == "cuda" else "host clock on the CPU"),
    })
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
