"""LTE-Tracker command line of the PyTorch/CUDA port.

reference: src/LTE-Tracker.cpp:114-373. The signal comes from the
built-in eNodeB simulator, played back through the same uint8
re-quantization as live data; the tracker runs on the CUDA card unless
``--device cpu`` asks for the plain PyTorch versions of the kernels.

Usage:
    python -m lte_cell_scanner_tpu_torch.tracker.cli -f 739e6 --simulate \\
        [--blocks 400] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.tracker.display import render_status
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)

BLOCKS_PER_STATUS = 200


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="LTE-Tracker",
        description="Track and monitor LTE cells on one frequency.")
    p.add_argument("-f", "--freq-center", type=float, required=True)
    p.add_argument("-c", "--correction", type=float, default=1.0,
                   help="crystal correction factor from a previous run")
    p.add_argument("-p", "--ppm", type=float, default=120,
                   help="crystal remaining frequency error (ppm)")
    p.add_argument("--simulate", action="store_true", required=True,
                   help="use the built-in eNodeB simulator as the source "
                        "(the only source of this port so far)")
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N 10000-sample blocks (default: forever)")
    p.add_argument("--engine-every", type=int, default=1,
                   help="engine cadence in 10000-sample blocks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("-v", "--verbose", action="count", default=1)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sig = synthetic_capture(n_subframes=400, freq_offset=4e3, snr_db=15)

    def on_event(kind, info):
        if args.verbose:
            print(f"[{kind}] {info}")

    trk = LTETracker(args.freq_center, engine_every=args.engine_every,
                     on_event=on_event, device=args.device)
    try:
        trk.kalibrate(playback_source(sig), ppm=args.ppm,
                      correction=args.correction)
    except RuntimeError as e:
        sys.exit(f"Error: {e}")

    src = playback_source(sig)
    done = 0
    while args.blocks is None or done < args.blocks:
        n = BLOCKS_PER_STATUS if args.blocks is None \
            else min(BLOCKS_PER_STATUS, args.blocks - done)
        done += trk.run(src, max_blocks=n)
        print(render_status(trk.status()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
