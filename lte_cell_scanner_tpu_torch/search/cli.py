"""CellSearch command line of the PyTorch/CUDA port.

reference: src/CellSearch.cpp:92-280 (arguments and their checks) and
:437-618 (the per-frequency loop and the result table with the crystal
correction factor). Captures come from recordings (``--load``), the
built-in eNodeB simulator (``--simulate``) or an RTL-SDR dongle (needs
pyrtlsdr); ``--record`` saves what was captured. The search runs on the
CUDA card unless ``--device cpu`` asks for the plain PyTorch versions of
the kernels, or unless ``--backend numpy`` asks for the float64 host
chain (the JAX package's default), candidate by candidate on the CPU;
``--interp 2stage`` runs the 2stage interpolator only there (the card
runs it as freq_time). ``--batch-sweep`` captures the whole sweep first,
then scans it in one batch and decodes every candidate in two batched
programs (parallel/fc_sweep.py); with ``--sweep-batch N`` it runs as a
pipeline over chunks of N captures (search/pipeline.py). ``--wideband FILE``
searches one wideband recording instead: every raster carrier of
[freq-start, freq-end] is channelized out of it on the device and swept
as one batch (search/wideband.py). With ``--device cuda`` (the default)
both batched sweeps spread over every visible card that the batch
divides over, as the JAX CLI does. One host thread dispatches every
shard and each shard pays the sweep's launches again, so on several
cards this is expected to be slower than ``--device cuda:0`` (one card)
until scaling across cards is measured (PERF.md).

Usage:
    python -m lte_cell_scanner_tpu_torch.search.cli \\
        --freq-start 739e6 --simulate [--device cuda|cpu]
    python -m lte_cell_scanner_tpu_torch.search.cli \\
        --freq-start 739e6 --simulate --backend numpy --interp 2stage
    python -m lte_cell_scanner_tpu_torch.search.cli \\
        --freq-start 739e6 --freq-end 745.3e6 --simulate \\
        --batch-sweep --sweep-batch 32
    python -m lte_cell_scanner_tpu_torch.search.cli \\
        --freq-start 739e6 --load --data-dir DIR
    python -m lte_cell_scanner_tpu_torch.search.cli \\
        --freq-start 724.3e6 --freq-end 753.8e6 --wideband FILE.it
    python -m lte_cell_scanner_tpu_torch.search.cli \\
        --freq-start 729e6 --freq-end 756e6 --wideband REC.sc16 \\
        --wideband-sc16 --fs-in 30.72e6 --fc-center 742.5e6
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.io.capture import CaptureSource
from lte_cell_scanner_tpu_torch.parallel.fc_sweep import all_cards_mesh
from lte_cell_scanner_tpu_torch.search.cell_search import (
    cell_search, dedup, generate_search_sets)
from lte_cell_scanner_tpu_torch.utils.device import resolve_device


def freq_formatter(freq: float) -> str:
    """Compact frequency with unit suffix (reference: CellSearch.cpp:322)."""
    for limit, div, suffix in ((998.0, 1.0, "h"), (998e3, 1e3, "k"),
                               (998e6, 1e6, "m"), (998e9, 1e9, "g")):
        if abs(freq) < limit:
            return f"{freq / div:5.3g}{suffix}"
    return str(freq)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="CellSearch",
        description="Search a range of frequencies for LTE cells.")
    p.add_argument("-s", "--freq-start", type=float, required=True,
                   help="frequency where the search should start (Hz)")
    p.add_argument("-e", "--freq-end", type=float, default=None,
                   help="frequency where the search should end "
                        "(default: freq-start)")
    p.add_argument("-p", "--ppm", type=float, default=120,
                   help="crystal remaining frequency error (ppm, default 120)")
    p.add_argument("-c", "--correction", type=float, default=1.0,
                   help="crystal correction factor from a previous run")
    p.add_argument("-r", "--record", action="store_true",
                   help="record captured data to data-dir")
    p.add_argument("-l", "--load", action="store_true",
                   help="load captured data from data-dir instead of the SDR")
    p.add_argument("--simulate", action="store_true",
                   help="use the built-in eNodeB simulator as the capture "
                        "source")
    p.add_argument("-d", "--data-dir", default=".",
                   help="directory for recorded/loaded captures")
    p.add_argument("-i", "--device-index", type=int, default=0,
                   help="SDR device index (live capture only)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the search: cuda (default; the "
                   "batched sweeps span every visible card), cuda:N (one "
                   "card) or cpu")
    p.add_argument("-v", "--verbose", action="count", default=1)
    p.add_argument("-b", "--brief", action="store_true",
                   help="only print the final result table")
    p.add_argument("--backend", choices=("torch", "numpy"),
                   default="torch",
                   help="torch (default): the search on --device; numpy: "
                   "the float64 host chain on the CPU (not with "
                   "--batch-sweep or --wideband)")
    p.add_argument("--interp", choices=("hex", "freq_time", "2stage"),
                   default="hex", help="channel-estimate interpolator "
                   "(2stage is real only with --backend numpy; the card "
                   "runs it as freq_time)")
    p.add_argument("--batch-sweep", action="store_true",
                   help="capture the whole sweep first, then scan it in "
                        "one batch and decode every candidate in two "
                        "batched programs (deferred output)")
    p.add_argument("--share-banks", action="store_true",
                   help="with --batch-sweep or --wideband: carriers "
                        "whose integer fold "
                        "schedules match share one template bank. "
                        "Detection-equivalent (~1e-6 relative scan "
                        "perturbation, far below the noise floor; the "
                        "decode re-derives everything in float64), but "
                        "scan scores are then not bit-equal to the "
                        "per-carrier search")
    p.add_argument("--sweep-batch", type=int, default=0, metavar="N",
                   help="with --batch-sweep: run the sweep as a pipeline "
                        "over chunks of N captures (uploads, scans and "
                        "decodes of adjacent chunks overlap, and only a "
                        "few chunks are on the card at a time; 0 = one "
                        "whole-sweep batch)")
    p.add_argument("--wideband", metavar="FILE", default=None,
                   help="search a single wideband .it recording (fs an "
                        "integer multiple of 1.92 Msps, fc field = band "
                        "center): every raster carrier in "
                        "[freq-start, freq-end] is channelized out of "
                        "the one capture on the device and swept as one "
                        "batch")
    p.add_argument("--fs-in", type=float, default=None,
                   help="wideband recording's sample rate (Hz; default: "
                        "the .it file's fs field, if the recording "
                        "carries one)")
    p.add_argument("--wideband-rtl-sdr", action="store_true",
                   help="the --wideband file is raw uint8 IQ (rtl_sdr "
                        "format) instead of .it; requires --fc-center")
    p.add_argument("--wideband-sc16", action="store_true",
                   help="the --wideband file is interleaved int16 IQ (sc16, "
                        "as UHD's rx_samples_to_file --type short writes) "
                        "instead of .it; requires --fs-in and --fc-center")
    p.add_argument("--fc-center", type=float, default=None,
                   help="wideband recording's center frequency (Hz; "
                        "required for raw recordings, overrides the .it "
                        "file's fc field otherwise)")
    return p


def validate(args) -> None:
    if args.freq_end is None:
        args.freq_end = args.freq_start
    if args.freq_end < args.freq_start:
        sys.exit("Error: end frequency must be >= start frequency")
    if args.record and args.load:
        sys.exit("Error: record and load are mutually exclusive")
    if args.ppm < 0:
        sys.exit("Error: ppm must be non-negative")
    if args.sweep_batch < 0:
        sys.exit("Error: sweep-batch must be non-negative")
    if args.backend == "numpy" and (args.batch_sweep or args.wideband):
        sys.exit("Error: --batch-sweep and --wideband require --backend "
                 "torch (the batched sweeps run on the device)")
    # Round to the 100 kHz raster like the reference.
    for name in ("freq_start", "freq_end"):
        f = getattr(args, name)
        r = round(f / 100e3) * 100e3
        if r != f:
            print(f"Warning: {name.replace('_', ' ')} rounded to the "
                  f"100 kHz raster: {r / 1e6:.4g} MHz")
            setattr(args, name, r)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    validate(args)
    verbosity = 0 if args.brief else args.verbose
    if args.backend == "torch":
        resolve_device(args.device)     # raises without CUDA unless cpu

    fc_search_set, f_search_set = generate_search_sets(
        args.freq_start, args.freq_end, args.ppm)
    if verbosity >= 2:
        print(f"Searching {len(fc_search_set)} center frequencies x "
              f"{len(f_search_set)} offset hypotheses")

    if args.wideband:
        return _wideband_sweep(args, f_search_set, verbosity)

    if args.simulate:
        source = CaptureSource("simulator", data_dir=args.data_dir,
                               record=args.record)
    elif args.load:
        source = CaptureSource("file", data_dir=args.data_dir)
    else:
        source = CaptureSource("rtlsdr", data_dir=args.data_dir,
                               record=args.record,
                               correction=args.correction,
                               device_index=args.device_index)

    if args.batch_sweep:
        return _batched_sweep(args, source, fc_search_set, f_search_set,
                              verbosity)

    all_cells = []
    for fc_requested in fc_search_set:
        if verbosity >= 1:
            print(f"Examining center frequency {fc_requested / 1e6:.4g} "
                  "MHz ...")
        t0 = time.time()
        capbuf, fc_programmed = _capture(source, fc_requested)
        cells = cell_search(capbuf, fc_requested, fc_programmed,
                            f_search_set=f_search_set, interp=args.interp,
                            verbose=verbosity, device=args.device,
                            backend=args.backend)
        if verbosity >= 2:
            print(f"  ({time.time() - t0:.2f}s)")
        all_cells.extend(cells)
    return print_results(dedup(all_cells), args.correction)


def _capture(source, fc_requested: float):
    try:
        return source.capture(fc_requested)
    except FileNotFoundError as e:
        sys.exit(f"Error: no recorded capture to load: {e.filename}")


def _print_per_carrier(fcs, per_cap) -> None:
    for b, fc in enumerate(fcs):
        for c in per_cap[b]:
            print(f"  {fc / 1e6:.4g} MHz: cell ID {c.n_id_cell()}: "
                  f"{c.n_rb_dl} RB, {c.cp_type} CP, foff "
                  f"{c.freq_superfine:+.1f} Hz")


def _sweep_device(device: str, n_captures: int):
    """(device, shard count) of a batched sweep: ``--device cuda`` (no
    index) spans every visible card that ``n_captures`` divides over, as
    the JAX CLI spreads a sweep over every device; any other device runs
    one shard."""
    if torch.device(device) == torch.device("cuda"):
        mesh = all_cards_mesh(n_captures)
        return mesh, len(mesh.devices)
    return device, 1


def _wideband_sweep(args, f_search_set, verbosity: int) -> int:
    """One wideband recording -> every raster carrier in range,
    channelized on --device in one pass and swept as one batch
    (search/wideband.py)."""
    from lte_cell_scanner_tpu_torch.io.itfile import load_it
    from lte_cell_scanner_tpu_torch.io.raw import load_rtl_sdr, load_sc16
    from lte_cell_scanner_tpu_torch.search.wideband import (
        wideband_carriers, wideband_search_sweep)

    if args.wideband_rtl_sdr and args.wideband_sc16:
        sys.exit("Error: --wideband-rtl-sdr and --wideband-sc16 are "
                 "mutually exclusive")
    if args.wideband_rtl_sdr or args.wideband_sc16:
        # Raw IQ (the dongle's uint8, an SDR's sc16) carries no metadata:
        # rate and center frequency come from the command line.
        flag = ("--wideband-sc16" if args.wideband_sc16
                else "--wideband-rtl-sdr")
        if args.fs_in is None:
            sys.exit(f"Error: {flag} requires --fs-in (the "
                     "recording's sample rate in Hz)")
        if args.fc_center is None:
            sys.exit(f"Error: {flag} requires --fc-center")
        wide = (load_sc16(args.wideband) if args.wideband_sc16
                else load_rtl_sdr(args.wideband, fs=args.fs_in))
        fc_center = args.fc_center
    else:
        d = load_it(args.wideband)
        wide = d["capbuf"]
        if args.fs_in is None and "fs" in d:
            args.fs_in = float(np.asarray(d["fs"]).ravel()[0])
        if args.fs_in is None:
            sys.exit("Error: --wideband requires --fs-in (the recording "
                     "carries no fs field)")
        fc_center = (args.fc_center if args.fc_center is not None
                     else float(np.asarray(d["fc"]).ravel()[0]))
    fcs = wideband_carriers(args.fs_in, fc_center, args.freq_start,
                            args.freq_end)
    if not fcs:
        sys.exit("Error: no raster carriers of [freq-start, freq-end] "
                 "fit the recording's usable bandwidth")
    if verbosity >= 1:
        print(f"Channelizing {len(fcs)} carrier(s) out of the "
              f"{args.fs_in / 1e6:.4g} Msps recording at "
              f"{fc_center / 1e6:.4g} MHz ...")
    t0 = time.time()
    device, n_shards = _sweep_device(args.device, len(fcs))
    per_cap, deduped = wideband_search_sweep(
        wide, args.fs_in, fc_center, fcs, np.asarray(f_search_set),
        device=device, share_banks=args.share_banks,
        interp="hex" if args.interp == "hex" else "freq_time")
    if verbosity >= 1:
        _print_per_carrier(fcs, per_cap)
        print(f"  wideband sweep: {len(fcs)} carrier(s) in "
              f"{time.time() - t0:.2f}s ({n_shards} device shard(s))")
    return print_results(deduped, args.correction)


def _batched_sweep(args, source, fc_search_set, f_search_set,
                   verbosity: int) -> int:
    """Whole-sweep batched path: capture everything, then one batched scan
    and two batched decode programs (parallel/fc_sweep.py), or the same as
    a pipeline over chunks of --sweep-batch captures (search/pipeline.py).
    """
    from lte_cell_scanner_tpu_torch.parallel.fc_sweep import \
        sharded_search_sweep
    from lte_cell_scanner_tpu_torch.search.pipeline import \
        pipelined_search_sweep

    caps, fcs, fc_progs = [], [], []
    for fc_requested in fc_search_set:
        if verbosity >= 1:
            print(f"Capturing {fc_requested / 1e6:.4g} MHz ...")
        capbuf, fc_prog = _capture(source, fc_requested)
        caps.append(capbuf)
        fcs.append(fc_requested)
        fc_progs.append(fc_prog)
    interp = "hex" if args.interp == "hex" else "freq_time"
    B = len(caps)
    t0 = time.time()
    if args.sweep_batch and B > args.sweep_batch:
        device, n_shards = _sweep_device(args.device, args.sweep_batch)
        per_cap, deduped = pipelined_search_sweep(
            np.stack(caps), fcs, np.asarray(f_search_set),
            device=device, batch=args.sweep_batch,
            fc_prog_list=fc_progs, share_banks=args.share_banks,
            interp=interp)
        mode = f"pipelined x{args.sweep_batch}"
    else:
        device, n_shards = _sweep_device(args.device, B)
        per_cap, deduped = sharded_search_sweep(
            np.stack(caps), fcs, np.asarray(f_search_set),
            device=device, fc_prog_list=fc_progs,
            share_banks=args.share_banks, interp=interp)
        mode = "single batch"
    if verbosity >= 1:
        _print_per_carrier(fcs, per_cap)
        print(f"  sweep: {B} fc in {time.time() - t0:.2f}s ({mode}, "
              f"{n_shards} device shard(s))")
    return print_results(deduped, args.correction)


def print_results(cells_final, correction: float) -> int:
    if not cells_final:
        print("No LTE cells were found...")
        return 1
    print("Detected the following cells:")
    print("A: #antenna ports C: CP type ; P: PHICH duration ; "
          "PR: PHICH resource type")
    print("CID A      fc   foff RXPWR C nRB P  PR CrystalCorrectionFactor")
    for c in cells_final:
        cp = {"normal": "N", "extended": "E"}.get(c.cp_type, "U")
        ph = {"normal": "N", "extended": "E"}.get(c.phich_duration, "U")
        pr = {1 / 6: "1/6", 1 / 2: "1/2", 1.0: "one", 2.0: "two"}.get(
            c.phich_resource, "UNK")
        crystal_actual = c.fc_requested - c.freq_superfine
        correction_new = correction * (c.fc_requested / crystal_actual)
        print(f"{c.n_id_cell():3d} {c.n_ports:1d} "
              f"{c.fc_requested / 1e6:6.5g}M "
              f"{freq_formatter(c.freq_superfine)} "
              f"{10.0 * np.log10(c.pss_pow):5.3g} {cp} {c.n_rb_dl:3d} "
              f"{ph} {pr} {correction_new:.20g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
