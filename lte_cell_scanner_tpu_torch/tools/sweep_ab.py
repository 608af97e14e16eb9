"""The one-card sweeps of two checkouts of the repository, in turns on one
card.

    python -m lte_cell_scanner_tpu_torch.tools.sweep_ab --against DIR \\
        [--rounds 3] [--reps 6]

``DIR`` holds another checkout of the repository (such as the parent
commit's, unpacked with ``git archive``). The inputs are made once from
seeds and saved under this checkout's ``build/``: 128 captures of the
simulator's cell 271 as the radio's uint8 planes
(tools/profile_pipeline.py), and an 80 ms recording at 30.72 Msps around
739 MHz with cells 271 and 503 planted at 741.0 and 732.7 MHz (the
simulator's captures upsampled x16). Each round then runs one process per
checkout, in the order other, this, this, other. Each process imports
its own checkout's package and times the three batched sweeps with no
device given (the entry points' defaults): the whole stack of 64
captures (``sharded_search_sweep``), the pipeline over 128 in chunks of
32 (``pipelined_search_sweep``) and the recording's 296 carriers
(``wideband_search_sweep``). It runs one warm-up each, then ``--reps``
rounds taking them in turns: the host clock around each call, ending in
a device sync. Last it runs one call of each under ``torch.profiler``,
for the device time and the count of device ops. The script checks
that every process decodes the same cells. It prints one JSON line per
process. The last line is the summary: each sweep's median ms per
carrier over each checkout's runs, with the card's name and power
limit. ``main`` returns the summary as a dict.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[2]
MARK = "SWEEP_AB "
FC0, PPM, WHOLE, PIPE = 739e6, 100, 64, (128, 32)
WB_FS, WB_CENTER, WB_DECIM = 30.72e6, 739e6, 16
WB_N = (153600 + 10) * WB_DECIM
WB_PLANTS = (
    (741.0e6, dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10.0,
                   freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3)),
    (732.7e6, dict(n_id_1=167, n_id_2=2, cp_type="extended", snr_db=10.0,
                   freq_offset=11e3, n_rb_dl=100, sfn_start=64, seed=3)))


def make_inputs(path: pathlib.Path) -> None:
    """Write the sweeps' inputs to ``path`` (.npz)."""
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.tools.profile_pipeline import \
        sweep_inputs
    from lte_cell_scanner_tpu_torch.utils.dsp import interpft

    planes, fcs, _ = sweep_inputs(PIPE[0], FC0)
    t = np.arange(WB_N)
    wide = np.zeros(WB_N, complex)
    for fc, kw in WB_PLANTS:
        cap = synthetic_capture(n_subframes=90, **kw)
        up = interpft(cap, len(cap) * WB_DECIM)[:WB_N]
        wide += up * np.exp(2j * np.pi * (fc - WB_CENTER) * t / WB_FS)
    rng = np.random.default_rng(11)
    wide += 0.001 * (rng.standard_normal(WB_N)
                     + 1j * rng.standard_normal(WB_N))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, planes=planes, fcs=np.asarray(fcs),
             wide=wide.astype(np.complex64))


def measure(inputs: str, reps: int) -> dict:
    """One process's timings of the three sweeps of the checkout whose
    package ``import`` finds (its PYTHONPATH)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import lte_cell_scanner_tpu_torch as pkg
    from lte_cell_scanner_tpu_torch.parallel.fc_sweep import \
        sharded_search_sweep
    from lte_cell_scanner_tpu_torch.search.cell_search import \
        generate_search_sets
    from lte_cell_scanner_tpu_torch.search.pipeline import \
        pipelined_search_sweep
    from lte_cell_scanner_tpu_torch.search.wideband import (
        wideband_carriers, wideband_search_sweep)

    d = np.load(inputs)
    planes, fcs, wide = d["planes"], [float(f) for f in d["fcs"]], d["wide"]
    _, fset = generate_search_sets(FC0, FC0, PPM)
    wfcs = wideband_carriers(WB_FS, WB_CENTER, WB_CENTER - WB_FS / 2,
                             WB_CENTER + WB_FS / 2)
    fns = {
        "whole": lambda: sharded_search_sweep(planes[:WHOLE], fcs[:WHOLE],
                                              fset)[0],
        "pipelined": lambda: pipelined_search_sweep(planes, fcs, fset,
                                                    batch=PIPE[1])[0],
        "wideband": lambda: wideband_search_sweep(wide, WB_FS, WB_CENTER,
                                                  wfcs, fset)[0]}
    n = {"whole": WHOLE, "pipelined": PIPE[0], "wideband": len(wfcs)}
    t0 = time.perf_counter()
    cells = {k: [[c.n_id_cell() for c in p] for p in fn()]
             for k, fn in fns.items()}
    runs = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs[k].append((time.perf_counter() - t1) * 1e3 / n[k])
    busy = {}
    for k, fn in fns.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        busy[k] = {"device_ms": sum(e.self_device_time_total
                                    for e in ev) / 1e3,
                   "device_ops": sum(e.count for e in ev)}
    return {"package": str(pathlib.Path(pkg.__file__).parents[1]),
            "ms_per_carrier": runs, "profiled": busy,
            "cells": cells, "seconds": time.perf_counter() - t0}


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip()


def _run(tree: pathlib.Path, inputs: pathlib.Path, reps: int,
         timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    r = subprocess.run([sys.executable, str(HERE), "--measure", str(inputs),
                        "--reps", str(reps)], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(MARK)]
    if r.returncode or not lines:
        raise RuntimeError(f"measurement in {tree} failed (rc "
                           f"{r.returncode}):\n{r.stdout[-2000:]}\n"
                           f"{r.stderr[-4000:]}")
    return json.loads(lines[-1][len(MARK):])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds allowed to each process")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        res = measure(args.measure, args.reps)
        print(MARK + json.dumps(res), flush=True)
        return res
    if not args.against:
        ap.error("--against DIR is required")
    trees = {"other": pathlib.Path(args.against).resolve(), "this": ROOT}
    inputs = ROOT / "build" / "sweep_ab_inputs.npz"
    t0 = time.perf_counter()
    make_inputs(inputs)
    print(f"inputs: {time.perf_counter() - t0:.1f} s", flush=True)
    per = {k: [] for k in trees}
    for _ in range(args.rounds):
        for who in ("other", "this", "this", "other"):
            res = _run(trees[who], inputs, args.reps, args.timeout)
            res["checkout"] = who
            print(json.dumps(res), flush=True)
            per[who].append(res)
    first = per["this"][0]["cells"]
    same = all(r["cells"] == first for rs in per.values() for r in rs)
    summary = {
        "card": _card(), "rounds": args.rounds, "reps": args.reps,
        "same_cells": same,
        "ms_per_carrier": {
            who: {k: float(np.median([v for r in rs
                                      for v in r["ms_per_carrier"][k]]))
                  for k in first}
            for who, rs in per.items()},
        "process_medians": {
            who: {k: [round(float(np.median(r["ms_per_carrier"][k])), 4)
                      for r in rs] for k in first}
            for who, rs in per.items()},
        "profiled": {who: [r["profiled"] for r in rs]
                     for who, rs in per.items()}}
    print(json.dumps(summary), flush=True)
    if not same:
        raise SystemExit("the two checkouts decode different cells")
    return summary


if __name__ == "__main__":
    main()
