"""Device latency of the PSS scan: the fused correlate+fold kernel alone and
the full scan (correlate+fold, delay spread, signal power, collapse and the
greedy peak search).

Times with CUDA events on the card: warm-up launches, then the median of
``--iters`` timed launches. ``--layout`` picks the kernel: "tea" and
"roll" (the JAX package's K1 and K2 layouts) both run ``xcorr_fold``,
"tea3" the Karatsuba kernel ``xcorr_fold3`` (K3). Both run on the tensor
cores: ``xcorr_fold`` with 3xTF32 products, ``xcorr_fold3`` with 3xTF32
products in float32 and, under ``--precision bf16``, one bf16 product per
tap (its bf16 mode). ``--precision bf16`` rounds the correlation's inputs
to bfloat16 at the JAX bf16 mode's rounding points; ``xcorr_fold`` then
runs its float32 kernel on the rounded values. The JAX tool's ``--tile``
sized a Mosaic VMEM block and has no counterpart here: each CUDA kernel's
tile is fixed, 160 lags of 8 hypotheses (``xcorr_fold``) or of 16
channels (``xcorr_fold3``).

The tensor-core work (``tc_gflop``) counts the function, not the
kernel's padding: 3 n_f channels x 9600 lags x n_comb folds x 137 complex
taps, at 8 real flops a tap (2x2) or 6 (Karatsuba), times the products
each real MAC takes (3 for 3xTF32, 1 for bf16); ``tc_bound_ms`` is that
over the H100's dense peak for the products' type (495 TFLOP/s TF32, 989
bf16), and ``tc_share`` that bound over the kernel's time (on the card
only).

Workload: one 80 ms capture (the simulator's, or ``--capture FILE.it``
with a ``capbuf`` record) at 739 MHz with the +-``--ppm`` hypothesis grid
(100 ppm: the full 31-hypothesis grid).

Usage:
    python -m lte_cell_scanner_tpu_torch.tools.bench_scan [--layout tea3]
        [--precision bf16] [--iters 50] [--ppm 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.constants import DS_COMB_ARM
from lte_cell_scanner_tpu_torch.ops import xcorr_torch
from lte_cell_scanner_tpu_torch.ops.peak_torch import (peak_search_device,
                                                       r_th1_normalized)
from lte_cell_scanner_tpu_torch.utils.device import (full_f32_matmuls,
                                                     resolve_device)

TILE = {"tea": 160, "roll": 160, "tea3": 160}   # lags per block of each kernel
WARMUP = 3
# H100 SXM dense tensor-core peaks, flop/s.
PEAK_TC = {"tf32": 495e12, "bf16": 989e12}


def get_capture(path=None):
    """(capbuf, fc): a recorded ``.it`` capture, or the simulator's."""
    if path:
        from lte_cell_scanner_tpu_torch.io.itfile import load_it

        d = load_it(path)
        return d["capbuf"], float(d["fc"][0])
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture

    return synthetic_capture(), 739e6


def time_ms(fn, iters: int, dev: torch.device) -> float:
    """Median milliseconds of fn(): CUDA events on the card, the host
    clock on the CPU (a CPU time is no device metric)."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
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
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--precision", choices=xcorr_torch.PRECISIONS,
                   default="f32",
                   help="bf16 rounds the correlation inputs (and runs "
                        "K3 in its bf16 mode)")
    p.add_argument("--layout", choices=("roll", "tea", "tea3"),
                   default="tea")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--ppm", type=float, default=100.0)
    p.add_argument("--capture", default=None,
                   help=".it file with a capbuf record (default: simulator)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    full_f32_matmuls()
    cap, fc = get_capture(args.capture)
    n_extra = int(np.floor((fc * args.ppm / 1e6 + 2.5e3) / 5e3))
    fset = np.arange(-n_extra, n_extra + 1) * 5e3
    n_cap = len(cap)

    plan = xcorr_torch.scan_plan(n_cap, fset, fc, fc, 1.92e6,
                                 layout=args.layout,
                                 precision=args.precision)
    cap2 = torch.from_numpy(
        np.stack([cap.real, cap.imag]).astype(np.float32)).to(dev)
    tpl = torch.from_numpy(plan.tpl).to(dev)
    starts = torch.from_numpy(plan.starts).to(dev)
    r_norm = r_th1_normalized(plan.n_comb_xc, DS_COMB_ARM)
    # The fold's inputs as xcorr_core forms them, made once: the fold
    # timing is the kernel's alone.
    if args.layout == "tea3":
        cap_x, tpl = xcorr_torch.karatsuba_inputs(cap2, tpl, args.precision)
        fold = xcorr_torch.xcorr_fold3
    else:
        cap_x = (xcorr_torch.round_bf16(cap2) if args.precision == "bf16"
                 else cap2)
        fold = xcorr_torch.xcorr_fold

    def correlate_fold():
        return fold(cap_x, tpl, starts, plan.n_comb_xc)

    def full_scan():
        packed, single, _ = xcorr_torch.xcorr_core(cap2, plan, DS_COMB_ARM)
        return peak_search_device(packed, single, r_norm, DS_COMB_ARM)

    results = {
        "correlate_fold_ms": time_ms(correlate_fold, args.iters, dev),
        "full_scan_ms": time_ms(full_scan, args.iters, dev),
    }
    peaks = full_scan().cpu().numpy()
    n_prod = 3 if args.layout == "tea3" else 4
    n_ch = 3 * len(fset)
    gflop = (2 * n_prod * n_ch * 137 * (n_cap - 136)) / 1e9
    # The tensor cores' work for the function, and its bound.
    bf16_mma = args.layout == "tea3" and args.precision == "bf16"
    tc_gflop = (n_ch * 9600 * plan.n_comb_xc * 137 * (2 * n_prod)
                * (1 if bf16_mma else 3)) / 1e9
    peak = PEAK_TC["bf16" if bf16_mma else "tf32"]
    tc_bound_ms = tc_gflop * 1e9 / peak * 1e3
    results.update({
        "metric": "device_scan_latency_ms",
        "value": results["full_scan_ms"],
        "unit": "ms",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "precision": args.precision,
        "layout": args.layout,
        "tile": TILE[args.layout],
        "n_f": len(fset),
        "n_comb_xc": plan.n_comb_xc,
        "matmul_gflop": round(gflop, 1),
        "tc_gflop": round(tc_gflop, 2),
        "tc_peak_tflops": peak / 1e12,
        "tc_bound_ms": tc_bound_ms,
        "tc_share": (tc_bound_ms / results["correlate_fold_ms"]
                     if dev.type == "cuda" else None),
        "samples_per_sec": int(n_cap / (results["full_scan_ms"] / 1e3)),
        "peaks": peaks.tolist(),
    })
    print(json.dumps({k: v for k, v in results.items() if k != "peaks"}))
    return results


if __name__ == "__main__":
    main()
