"""The readings that set the limits in ``configs/*.json`` (``PERF.md``
gives them). Not part of a run.

- ``--control``, search cells: the reference put in the program's place
  and computed in TF32, the nearest precision below the configuration's
  float32 with TF32 off, against the float64 reference on the captures a
  run samples. Every operand that the reference's stages take from numpy
  carries TF32's 10-bit mantissa (exponentials, FFTs: the scan's bank and
  correlations, the sync and FOE rotations, the grid and the tfoec
  rotations), and every accumulation (sums, means, running sums) and
  every square root, magnitude, angle and logarithm comes out in float32,
  in every module of ``benchmark/reference/``.
- ``--control``, tracker cells: the compared numbers are decisions (which
  cells are held, which MIBs decode), so the control breaks one stated
  guarantee: every MIB decode's CRC check fails, through a short window
  at the cell's own load.
- ``--program``: the program's own readings of the same numbers, a
  process for many seeds (search cells: every capture of the pool
  searched once as the window searches it).

    python3 -m benchmark.control --workload band17.sweep --seeds 1 2 3 \\
        --control
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import sys

import numpy as np

from benchmark import check
from benchmark.entries import make_entry
from benchmark.manifest import load_cell
from benchmark.trace import Spans


def tf32_round(x: np.ndarray) -> np.ndarray:
    """Round to TF32 (10 mantissa bits), nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` does; float32 first, returned as float64."""
    bits = np.asarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
    bits = ((bits + 0x1000) & ~0x1FFF).astype(np.uint32).view(np.int32)
    return bits.view(np.float32).astype(np.float64)


def _f32_round(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).astype(np.float64)


def _rounding(fn, rnd):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        out = np.asarray(fn(*args, **kwargs))
        if out.dtype.kind == "c":
            out = rnd(out.real) + 1j * rnd(out.imag)
        elif out.dtype.kind == "f":
            out = rnd(out)
        return out[()]
    return call


class _Numpy:
    """numpy, with the results of some functions rounded."""

    def __init__(self, base, rounded: dict):
        self._base, self._rounded = base, rounded

    def __getattr__(self, name):
        if name in self._rounded:
            return self._rounded[name]
        return getattr(self._base, name)


TF32_NUMPY = _Numpy(np, {
    "exp": _rounding(np.exp, tf32_round),
    **{f: _rounding(getattr(np, f), _f32_round)
       for f in ("sum", "mean", "cumsum", "sqrt", "abs", "angle", "log")},
    "fft": _Numpy(np.fft, {f: _rounding(getattr(np.fft, f), tf32_round)
                           for f in ("fft", "ifft")}),
})


def _reference_modules():
    import benchmark.reference  # noqa: F401

    return [m for name, m in sorted(sys.modules.items())
            if name.startswith("benchmark.reference.") and m is not None]


def _clear_caches(mods) -> None:
    for m in mods:
        for v in vars(m).values():
            if hasattr(v, "cache_clear"):
                v.cache_clear()


@contextlib.contextmanager
def tf32_reference():
    """The reference computed in TF32 while the block runs."""
    import benchmark.reference.search  # noqa: F401  every stage loaded

    mods = [m for m in _reference_modules() if getattr(m, "np", None) is np]
    _clear_caches(mods)
    for m in mods:
        m.np = TF32_NUMPY
    try:
        yield
    finally:
        for m in mods:
            m.np = np
        _clear_caches(mods)


def _entry(name: str, seed: int, device):
    cell = load_cell(name)
    return make_entry(cell.config, cell.traffic, seed, device, Spans())


def search_control(name: str, seed: int) -> dict:
    import torch

    entry = _entry(name, seed, torch.device("cpu"))
    entry.make_inputs()
    entry.results = {(r, b): None for r in range(len(entry.pool))
                     for b in range(len(entry.fcs))}
    pairs = []
    for key in entry.sample():
        with tf32_reference():
            control = entry.reference(key)
        pairs.append((control, entry.reference(key)))
    return check.compare_search(pairs)


def search_program(name: str, seed: int) -> dict:
    """The program at the cell's size: the sweep's set-up searches every
    recording once; the serial entry then visits every capture once."""
    import torch

    dev = torch.device("cuda")
    from lte_cell_scanner_tpu_torch.kernels.build import build

    build()
    entry = _entry(name, seed, dev)
    entry.setup({})
    if hasattr(entry, "order"):
        for _ in entry.order:
            entry.step()
    torch.cuda.synchronize(dev)
    out = entry.numbers()
    del entry
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tracker_run(name: str, seed: int, seconds: float, broken: bool) -> dict:
    from benchmark.harness import run_cell

    if broken:
        from lte_cell_scanner_tpu_torch.tracker import batch_runtime

        batch_runtime._mib_check = lambda cell, c_est: False
    run = run_cell(name, seed, seconds, False)
    return {k: v["value"] for k, v in run.checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--control", action="store_true")
    mode.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    limits = cell.config["check"]
    for seed in args.seeds:
        if cell.traffic["entry"] == "tracker":
            numbers = tracker_run(args.workload, seed, args.seconds,
                                  args.control)
        elif args.control:
            numbers = search_control(args.workload, seed)
        else:
            numbers = search_program(args.workload, seed)
        ok, checks = check.judge(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": "control" if args.control else "program",
                          "correct": ok, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
