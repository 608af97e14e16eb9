"""LTE-Tracker command line of the PyTorch/CUDA port.

reference: src/LTE-Tracker.cpp:114-373 (the CLI with its hidden --load /
--repeat / --drop / --rtl_sdr / --noise-power playback flags). The signal
is a recording played back from a file (``--load``: an ``.it`` capture,
or raw rtl_sdr bytes with ``--rtl-sdr-format``) or the built-in eNodeB
simulator (``--simulate``), pushed through the same uint8
re-quantization as live data. The tracker runs on the CUDA card unless
``--device cpu`` asks for the plain PyTorch versions of the kernels.
``--no-batch`` runs the host data plane (one float64 CellTracker per cell,
fed sample-carrying PDUs) instead of the batched engine, and ``--backend
numpy`` the searcher and the calibration as the float64 host chain: with
both, nothing runs on a device (the JAX package's defaults).

Usage:
    python -m lte_cell_scanner_tpu_torch.tracker.cli -f 739e6 \\
        --load capture.it [--no-repeat] [--noise-power P] [--blocks 1000]
    python -m lte_cell_scanner_tpu_torch.tracker.cli -f 739e6 \\
        --load capture.raw --rtl-sdr-format [--drop 0.5]
    python -m lte_cell_scanner_tpu_torch.tracker.cli -f 739e6 --simulate \\
        [--feeder native] [--expert] [--display] [--device cuda|cpu]
    python -m lte_cell_scanner_tpu_torch.tracker.cli -f 739e6 --simulate \\
        --no-batch --backend numpy [--feeder native]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

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
    p.add_argument("--load", help="playback: .it capture or raw rtl_sdr file")
    p.add_argument("--rtl-sdr-format", action="store_true",
                   help="loaded file is raw uint8 IQ, not .it")
    p.add_argument("--repeat", action="store_true", default=True)
    p.add_argument("--no-repeat", dest="repeat", action="store_false")
    p.add_argument("--drop", type=float, default=0.0,
                   help="seconds to drop from the start of the file")
    p.add_argument("--noise-power", type=float, default=None,
                   help="add AWGN of this power to the playback")
    p.add_argument("--simulate", action="store_true",
                   help="use the built-in eNodeB simulator as the source")
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N 10000-sample blocks (default: forever)")
    p.add_argument("--backend", choices=("torch", "numpy"),
                   default="torch",
                   help="searcher and calibration: torch (default: the "
                   "cell search on --device) or numpy (the float64 host "
                   "chain)")
    p.add_argument("--batch", action="store_true", default=True,
                   help="the batched engine on --device (default)")
    p.add_argument("--no-batch", dest="batch", action="store_false",
                   help="one host CellTracker per cell (float64), fed "
                   "sample-carrying PDUs")
    p.add_argument("--engine-every", type=int, default=1,
                   help="engine cadence in 10000-sample blocks")
    p.add_argument("--feeder", choices=("python", "native"),
                   default="python",
                   help="sample-feeder implementation (native = C++)")
    p.add_argument("--display", action="store_true",
                   help="interactive curses UI (j/k select, h/l views, "
                        "? help)")
    p.add_argument("--expert", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("-v", "--verbose", action="count", default=1)
    for i in range(1, 10):
        # Hidden scratch debug globals, mirrored from the reference
        # (src/LTE-Tracker.cpp:52-60): free-form experiment knobs that
        # land in GlobalState.debug_g and show in the expert status.
        p.add_argument(f"--g{i}", type=float, default=0.0,
                       help=argparse.SUPPRESS)
    return p


def get_signal(args) -> np.ndarray:
    if args.simulate:
        from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture

        return synthetic_capture(n_subframes=400, freq_offset=4e3,
                                 snr_db=15)
    if args.load:
        if args.rtl_sdr_format:
            from lte_cell_scanner_tpu_torch.io.raw import load_rtl_sdr

            return load_rtl_sdr(args.load, drop_seconds=args.drop)
        from lte_cell_scanner_tpu_torch.io.itfile import load_it

        sig = load_it(args.load)["capbuf"]
        return sig[int(args.drop * 1.92e6):]
    sys.exit("Error: live SDR tracking requires --load or --simulate in "
             "this build (no dongle support compiled in)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sig = get_signal(args)

    def on_event(kind, info):
        if args.verbose:
            print(f"[{kind}] {info}")

    trk = LTETracker(args.freq_center, backend=args.backend,
                     batch=args.batch, engine_every=args.engine_every,
                     feeder=args.feeder, on_event=on_event,
                     device=args.device)
    trk.state.debug_g = tuple(getattr(args, f"g{i}") for i in range(1, 10))
    try:
        trk.kalibrate(playback_source(sig, repeat=args.repeat,
                                      noise_power=args.noise_power),
                      ppm=args.ppm, correction=args.correction)
    except RuntimeError as e:
        sys.exit(f"Error: {e}")

    src = playback_source(sig, repeat=args.repeat,
                          noise_power=args.noise_power, seed=1)
    if args.display:
        from lte_cell_scanner_tpu_torch.tracker.curses_display import (
            run_curses)

        run_curses(trk, src, max_blocks=args.blocks)
        return 0
    done = 0
    while args.blocks is None or done < args.blocks:
        n = BLOCKS_PER_STATUS if args.blocks is None \
            else min(BLOCKS_PER_STATUS, args.blocks - done)
        got = trk.run(src, max_blocks=n)
        done += got
        if got < n:
            break  # source exhausted
        print(render_status(trk.status(), expert=args.expert, tracker=trk),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
