"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, without
a CUDA card (or with fewer cards than the cell asks for), and when
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed. The set-up's parts print on an earlier line; the
numbers compared print beside their limits as the last lines on standard
error and under the result's last key, ``checks``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.manifest import ROOT  # noqa: E402

# Every cache a run can write stays at a fixed path inside the checkout
# (the program's own nvcc and g++ outputs go to build/ already).
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ.setdefault(_var, str(ROOT / "build" / "bench_cache" / _dir))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t = time.perf_counter()
    import torch

    from benchmark.harness import (banned_modules, result_line, run_cell)
    from benchmark.manifest import load_cell

    chips = load_cell(args.workload).chips
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); this "
              f"machine has {count}", file=sys.stderr)
        return 2
    parts = {"import": time.perf_counter() - t}
    run = run_cell(args.workload, args.seed % 2 ** 64, args.seconds,
                   bool(args.trace), device="cuda", t_start=T_START,
                   parts=parts)
    banned = banned_modules()
    if banned:
        print(f"benchmark: loaded after the window: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"setup_parts_s": run.setup_parts,
                      "check_s": run.check_s}), flush=True)
    if run.answers:
        print(f"answers: {json.dumps(run.answers)}", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {run.correct}", file=sys.stderr, flush=True)
    print(json.dumps(result_line(run)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
