"""Device time of the wideband channelizer, per carrier.

Measures the cost of turning ONE wideband capture into a whole fc sweep's
worth of 1.92 Msps channels (80 ms each), for both formulations in
search/wideband.py:

- ``bank``: the one-pass filter bank (a strided convolution with the
  modulated kernel, then the exact two-level post-rotation), the path of
  ``wideband_search_sweep``;
- ``map``:  the per-carrier baseline (its time grows linearly with the
  carrier count).

Each form's ``run`` is timed at steady state with CUDA events (warm-up,
then the median of ``--iters``; on the CPU the host clock, which is no
device metric). The wide capture is made on the host from a seed and
uploaded once, outside the timing. Carriers: ``--carriers`` on the
100 kHz raster around 750 MHz.

No reference equivalent: the reference retunes the dongle per carrier
(src/CellSearch.cpp:471-481).

Usage:
    python -m lte_cell_scanner_tpu_torch.tools.bench_wideband
        [--decim 16] [--carriers 16] [--iters 24] [--skip-map]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.search.wideband import (
    CAPLENGTH, make_channelizer, make_channelizer_map)
from lte_cell_scanner_tpu_torch.tools.bench_scan import time_ms
from lte_cell_scanner_tpu_torch.utils.device import resolve_device, upload


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--decim", type=int, default=16,
                   help="decimation (fs_in = decim * 1.92 Msps)")
    p.add_argument("--carriers", type=int, default=16)
    p.add_argument("--iters", type=int, default=24)
    p.add_argument("--skip-map", action="store_true",
                   help="skip the slow per-carrier baseline")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    fs_in = args.decim * 1.92e6
    fc_center = 750e6
    # 100 kHz-raster carriers straddling the band center.
    fcs = [fc_center + (i - args.carriers // 2) * 100e3
           for i in range(args.carriers)]
    n_wide = (CAPLENGTH + 64) * args.decim
    rng = np.random.default_rng(0)
    planes = upload(rng.standard_normal((2, n_wide)).astype(np.float32), dev)

    bank = make_channelizer(fs_in, fc_center, fcs, n_wide, device=dev)
    bank_ms = time_ms(lambda: bank(planes), args.iters, dev)
    res = {
        "metric": "wideband_channelize_ms_per_carrier",
        "value": bank_ms / args.carriers,
        "unit": "ms",
        "carriers": args.carriers,
        "decim": args.decim,
        "n_out": bank.n_out,
        "bank_ms": bank_ms,
        "carriers_per_sec": args.carriers / bank_ms * 1e3,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if not args.skip_map:
        per = make_channelizer_map(fs_in, fc_center, fcs, n_wide, device=dev)
        res["map_ms"] = time_ms(lambda: per(planes), args.iters, dev)
        res["speedup_vs_map"] = res["map_ms"] / bank_ms
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
