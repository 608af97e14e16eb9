"""Device latency of the tracker's symbol demod (the ``fd_demod_stream``
kernel, csrc/fd_demod.cu in its stream mode) by launch size.

The tracker engine demodulates every symbol window of a cycle in one
launch: tens of windows per cycle for one cell at one engine cycle per
block, 403,200 for 96 cells x 300 ms cycles. ``--windows`` lists the
launch sizes. Each size gets N windows at random starts in a random u8
I/Q stream of ``--samples`` samples (300 ms of signal by default), with
random FOC rates, bulk phases and lateness, made from ``--seed``.

Variants, timed back to back with CUDA events (warm-up, then the median of
``--iters`` single launches):

  plain — ``fd_demod_stream_plain``, the PyTorch version
  cuda  — ``fd_demod_stream``, the hand-written kernel

Before timing, the kernel's output must lie within 1e-4 x max of the plain
version's at every size.

Usage:
    python -m lte_cell_scanner_tpu_torch.tools.bench_demod
        [--windows 75,1050,403200] [--iters 50] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.ops.fd_demod import (fd_demod_stream,
                                                     fd_demod_stream_plain)
from lte_cell_scanner_tpu_torch.tools.bench_scan import time_ms
from lte_cell_scanner_tpu_torch.utils.device import resolve_device


def stream_inputs(n: int, n_samples: int, rng, dev: torch.device):
    """(seg_u8, starts, foc, bpo, late) of N windows in a random stream."""
    t = torch.from_numpy
    return (t(rng.integers(0, 256, (n_samples, 2), dtype=np.uint8)).to(dev),
            t(rng.integers(0, n_samples - 128, n).astype(np.int32)).to(dev),
            t(rng.uniform(-0.05, 0.05, n).astype(np.float32)).to(dev),
            t(rng.uniform(-np.pi, np.pi, n).astype(np.float32)).to(dev),
            t(rng.uniform(-2, 2, n).astype(np.float32)).to(dev))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", default="75,1050,403200",
                    help="comma-separated launch sizes (windows)")
    ap.add_argument("--samples", type=int, default=576000)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; on the CPU "
                         "both variants run the plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)

    results = {"samples": args.samples,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"), "sizes": []}
    for n in (int(w) for w in args.windows.split(",")):
        inputs = stream_inputs(n, args.samples, rng, dev)
        want = fd_demod_stream_plain(*inputs)
        err = float((fd_demod_stream(*inputs) - want).abs().max())
        mx = float(want.abs().max())
        if not err <= 1e-4 * mx:
            raise SystemExit(f"fd_demod_stream at N={n}: max abs err "
                             f"{err:.3e} above 1e-4 x max {mx:.3e}")
        results["sizes"].append({
            "windows": n, "max_abs_err": err,
            "plain_ms": time_ms(lambda: fd_demod_stream_plain(*inputs),
                                args.iters, dev),
            "cuda_ms": time_ms(lambda: fd_demod_stream(*inputs),
                               args.iters, dev)})
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
