"""CellSearch command line of the PyTorch/CUDA port (single-capture path).

reference: src/CellSearch.cpp:92-280 (arguments) and :437-618 (the
per-frequency loop and the result table). Captures come from the
built-in eNodeB simulator; the search runs on the CUDA card unless
``--device cpu`` asks for the plain PyTorch versions of the kernels.

Usage:
    python -m lte_cell_scanner_tpu_torch.search.cli \\
        --freq-start 739e6 --simulate [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.search.cell_search import (
    cell_search, dedup, generate_search_sets)


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
    p.add_argument("--simulate", action="store_true", required=True,
                   help="use the built-in eNodeB simulator as the capture "
                        "source (the only source of this port so far)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--interp", choices=("hex", "freq_time"), default="hex",
                   help="channel-estimate interpolator (default hex)")
    p.add_argument("-v", "--verbose", action="count", default=1)
    p.add_argument("-b", "--brief", action="store_true",
                   help="only print the final result table")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.freq_end is None:
        args.freq_end = args.freq_start
    if args.freq_end < args.freq_start:
        sys.exit("Error: end frequency must be >= start frequency")
    if args.ppm < 0:
        sys.exit("Error: ppm must be non-negative")
    # Round to the 100 kHz raster like the reference.
    args.freq_start = round(args.freq_start / 100e3) * 100e3
    args.freq_end = round(args.freq_end / 100e3) * 100e3
    verbosity = 0 if args.brief else args.verbose

    fc_search_set, f_search_set = generate_search_sets(
        args.freq_start, args.freq_end, args.ppm)
    all_cells = []
    for fc_requested in fc_search_set:
        if verbosity >= 1:
            print(f"Examining center frequency {fc_requested / 1e6:.4g} "
                  "MHz ...")
        t0 = time.time()
        capbuf = synthetic_capture()
        cells = cell_search(capbuf, fc_requested, fc_requested,
                            f_search_set=f_search_set, interp=args.interp,
                            verbose=verbosity, device=args.device)
        if verbosity >= 2:
            print(f"  ({time.time() - t0:.2f}s)")
        all_cells.extend(cells)
    return print_results(dedup(all_cells), args.correction)


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
