"""Device latency of the batched tail-biting Viterbi decoder, per variant.

The MIB decode tail runs 64 candidates x 4 frame timings x 3 port
hypotheses = 768 decodes of 40 bits per batch (``--batch``). Variants,
timed back to back in one process with CUDA events (warm-up, then the
median of ``--iters``):

  plain — ``models/viterbi.py::viterbi_tl_plain``, the PyTorch version
          (the counterpart of the JAX package's XLA variants loop_gather
          and loop_onehot of ``convcode_jax._decode_one``)
  cuda  — ``viterbi_tl``, the hand-written kernel (csrc/viterbi.cu, which
          replaces models/viterbi_pallas.py)

Before timing, each variant's bits must equal the host decoder's
(``models/convcode.lte_conv_decode``) on every row. Reference workload:
src/searcher.cpp:1438-1542 (decode_mib's per-hypothesis viterbi loop).

Usage:
    python -m lte_cell_scanner_tpu_torch.tools.bench_viterbi [--iters 50]
        [--batch 768] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.models import viterbi
from lte_cell_scanner_tpu_torch.models.convcode import (lte_conv_decode,
                                                        lte_conv_encode)
from lte_cell_scanner_tpu_torch.tools.bench_scan import time_ms
from lte_cell_scanner_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=768)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; on the CPU "
                         "both variants run the plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (args.batch, 40)).astype(np.uint8)
    # (B, 3, 40): encode -> BPSK -> 0 dB AWGN -> LLR (as the parity test)
    llrs = np.stack([2.0 * ((1.0 - 2.0 * lte_conv_encode(b).astype(
        np.float64)) + rng.standard_normal((3, 40))) for b in bits])
    llrs32 = llrs.astype(np.float32)
    host = np.stack([lte_conv_decode(l) for l in llrs32])
    # Time-major (n_steps, 12, B), the layout of the MIB chain.
    llr_tl = torch.from_numpy(llrs32).to(dev).transpose(1, 2).reshape(
        args.batch, 10, 12).permute(1, 2, 0).contiguous()

    # "backend": the device type the decoders ran on (the JAX tool's
    # jax.default_backend()).
    results = {"batch": args.batch, "backend": dev.type,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
    for key, fn in (("plain", viterbi.viterbi_tl_plain),
                    ("cuda", viterbi.viterbi_tl)):
        got = fn(llr_tl).T.cpu().numpy().astype(np.uint8)
        bad = int(np.sum(np.any(got != host, axis=1)))
        if bad:
            raise SystemExit(f"variant {key} disagrees with the host "
                             f"decoder on {bad}/{args.batch} rows")
        results[f"{key}_bits_equal"] = True
        results[f"{key}_ms"] = time_ms(lambda: fn(llr_tl), args.iters, dev)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
