"""The search's scan stage under two builds of the ``xcorr_fold`` kernel,
in one process on the card.

    python -m lte_cell_scanner_tpu_torch.tools.scan_stage_ab --against OTHER.cu

Builds ``OTHER.cu`` (another revision of ``csrc/xcorr_fold.cu`` with the
same C interface, such as the parent commit's) beside this checkout's
kernel. Then it times the scan stage of ``cell_search``, ``scan_plan`` and
``xcorr_core`` on the simulator's capture with the 31-hypothesis grid,
with each kernel in turn, in ``--rounds`` rounds of other, this, this,
other: the host clock around a call that ends in a device sync, CUDA
events around the same call, and CUDA events around the kernel's call
alone, each the median of ``--iters`` calls after 3 warm-up calls; then
the host planning ``scan_plan`` alone. Two commits'
end-to-end stage times differ by more than the kernel when they run in
two processes; here nothing else differs. Prints one JSON line and
returns its dict.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import DS_COMB_ARM
from lte_cell_scanner_tpu_torch.kernels import build as kb
from lte_cell_scanner_tpu_torch.ops import xcorr_torch
from lte_cell_scanner_tpu_torch.search.cell_search import generate_search_sets
from lte_cell_scanner_tpu_torch.tools.bench_scan import WARMUP, get_capture
from lte_cell_scanner_tpu_torch.utils.device import full_f32_matmuls


def _other_launcher(source: str):
    out = kb.BUILD_DIR / "scan_stage_ab_other.so"
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(out), source],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).xcorr_fold_launch
    fn.argtypes = list(kb._SIGNATURES["xcorr_fold"][2])
    fn.restype = ctypes.c_int
    return fn


def _median_ms(fn, iters: int, events: bool) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if events:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", required=True,
                   help="another revision of csrc/xcorr_fold.cu")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_stage_ab needs the CUDA card")
    full_f32_matmuls()
    dev = torch.device("cuda")
    fns = {"this": kb.launcher("xcorr_fold"),
           "other": _other_launcher(args.against)}
    cap, fc = get_capture()
    _, fset = generate_search_sets(fc, fc, 100)
    cap_ri = torch.from_numpy(
        np.stack([cap.real, cap.imag], -1).astype(np.float32)).to(dev)

    def stage():
        plan = xcorr_torch.scan_plan(len(cap), fset, fc, fc, 1.92e6)
        return xcorr_torch.xcorr_core(cap_ri.T.contiguous(), plan,
                                      DS_COMB_ARM)

    plan = xcorr_torch.scan_plan(len(cap), fset, fc, fc, 1.92e6)
    fold_args = (cap_ri.T.contiguous(), torch.from_numpy(plan.tpl).to(dev),
                 torch.from_numpy(plan.starts).to(dev), plan.n_comb_xc)

    def kernel():
        return xcorr_torch.xcorr_fold(*fold_args)

    runs = {k: {"host_ms": [], "events_ms": [], "kernel_events_ms": []}
            for k in fns}
    for _ in range(args.rounds):
        for k in ("other", "this", "this", "other"):
            kb._FNS["xcorr_fold"] = fns[k]
            runs[k]["host_ms"].append(_median_ms(stage, args.iters, False))
            runs[k]["events_ms"].append(_median_ms(stage, args.iters, True))
            runs[k]["kernel_events_ms"].append(
                _median_ms(kernel, args.iters, True))
    kb._FNS["xcorr_fold"] = fns["this"]
    res = {"metric": "scan_stage_ms", "device": torch.cuda.get_device_name(0),
           "n_f": len(fset), "runs": runs}
    for k, r in runs.items():
        for m, v in r.items():
            res[f"{k}_{m}_median"] = float(np.median(v))
            res[f"{k}_{m}_quartiles"] = [float(np.percentile(v, 25)),
                                         float(np.percentile(v, 75))]
    res["this_host_below_other"] = sum(
        a < b for a, b in zip(runs["this"]["host_ms"],
                              runs["other"]["host_ms"]))
    res["pairs"] = len(runs["this"]["host_ms"])
    res["scan_plan_host_ms"] = _median_ms(
        lambda: xcorr_torch.scan_plan(len(cap), fset, fc, fc, 1.92e6),
        args.iters, False)
    res["this_kernel_below_other"] = sum(
        a < b for a, b in zip(runs["this"]["kernel_events_ms"],
                              runs["other"]["kernel_events_ms"]))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
