#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lte_cell_scanner_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases; the script exits non-zero if any fails:

1. Print the card (nvidia-smi name and power limit) and build the three
   CUDA kernels from csrc/ (one nvcc each, started together).
2. Hold each kernel against its plain PyTorch version at the shapes of the
   main path: the scan at 80 ms and the full 31-hypothesis grid (plus an
   extreme +-600 kHz grid), the symbol demod and the Viterbi decoder at the
   MIB batch of 64 candidates (25,216 windows, 768 codewords).
3. Drive the main path, cell_search on simulator captures at 739 MHz with
   the 31-hypothesis grid (normal CP / 50 RB and extended CP / 100 RB),
   with the kernels' launch counts set to 0 just before and read just
   after; check the decoded cells against the simulator's truth and
   against the same search through the plain versions on the CPU.
4. Time each kernel, its plain version and the end-to-end search with CUDA
   events (3 warm-up runs, median of 20).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits with 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores, FMA = 2
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
WARMUP, REPS = 3, 20
FC = 739e6
CAPTURES = {
    "normal": dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10.0,
                   freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3),
    "extended": dict(n_id_1=167, n_id_2=2, cp_type="extended", snr_db=10.0,
                     freq_offset=11e3, n_rb_dl=100, sfn_start=64, seed=3),
}
CELL_FIELDS = ("n_id_2", "n_id_1", "cp_type", "frame_start", "n_ports",
               "n_rb_dl", "phich_duration", "phich_resource", "sfn")

failures = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn) -> float:
    """Median wall milliseconds of fn() ending in a device sync."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def stage_breakdown(capbuf, cp: str, fset) -> None:
    """Host-clock milliseconds of each stage of cell_search (median of
    REPS), each ending in a device sync."""
    import torch

    from lte_cell_scanner_tpu_torch.ops import mib_torch, xcorr_torch
    from lte_cell_scanner_tpu_torch.ops.peak_torch import (
        peak_search_device, peaks_to_cells, r_th1_normalized)
    from lte_cell_scanner_tpu_torch.ops.sync_torch import sss_foe_batch

    dev = torch.device("cuda")
    state = {}

    def upload():
        state["cap"] = torch.from_numpy(np.stack(
            [capbuf.real, capbuf.imag], -1).astype(np.float32)).to(dev)

    def scan():
        plan = xcorr_torch.scan_plan(len(capbuf), fset, FC, FC, 1.92e6)
        state["scan"] = xcorr_torch.xcorr_core(state["cap"].T.contiguous(),
                                               plan, 2)
        state["plan"] = plan

    def peaks():
        packed, single, _ = state["scan"]
        state["peaks"] = peaks_to_cells(peak_search_device(
            packed, single, r_th1_normalized(state["plan"].n_comb_xc, 2),
            2).cpu().numpy(), fset, FC, FC)

    def sync():
        state["alive"] = [c for c in sss_foe_batch(state["peaks"],
                                                   state["cap"], 3.0)
                          if c.n_id_1 >= 0]

    def mib():
        for cpt in ("normal", "extended"):
            group = [c for c in state["alive"] if c.cp_type == cpt]
            mib_torch.decode_mib_batch(group, state["cap"])

    parts = [(name, host_ms(fn)) for name, fn in (
        ("upload", upload), ("scan", scan), ("peaks", peaks),
        ("sync", sync), ("mib", mib))]
    groups = sorted({c.cp_type for c in state["alive"]})
    print(f"  stages ({cp} CP, {len(state['peaks'])} peaks, "
          f"{len(state['alive'])} synced, MIB groups {groups}): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in parts))


def device_busy(fn, wall_ms: float) -> None:
    """Device time of one call under torch.profiler against the unprofiled
    wall time: the device's busy share, and the kernels that fill it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    n_ops = sum(e.count for e in events)
    print(f"profile: device busy {dev_us / 1e3:.3f} ms of {wall_ms:.3f} ms "
          f"wall ({100 * dev_us / 1e3 / wall_ms:.1f}%), {n_ops} device ops "
          "(kernels and copies)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:60]:60s} {e.count:5d} x "
              f"{e.self_device_time_total / 1e3:.3f} ms")


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from lte_cell_scanner_tpu_torch import kernels
        from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
        from lte_cell_scanner_tpu_torch.kernels.build import build
        from lte_cell_scanner_tpu_torch.models import viterbi
        from lte_cell_scanner_tpu_torch.ops import mib_torch, xcorr_torch
        from lte_cell_scanner_tpu_torch.ops.fd_demod import (fd_demod,
                                                             fd_demod_plain)
        from lte_cell_scanner_tpu_torch.ops.sync_torch import sss_foe_batch
        from lte_cell_scanner_tpu_torch.ops.peak_torch import (
            peak_search_device, peaks_to_cells, r_th1_normalized)
        from lte_cell_scanner_tpu_torch.search.cell_search import (
            cell_search, dedup, generate_search_sets)
        from lte_cell_scanner_tpu_torch.utils.device import full_f32_matmuls
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: "
              f"{e}", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    full_f32_matmuls()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build.
    t0 = time.perf_counter()
    built = build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for "
          f"{len(built)} kernels (parallel nvcc)")
    for name, (sec, log) in built.items():
        print(f"  {name}: {sec:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")

    # ---- 2. kernels vs plain versions at main-path shapes.
    _, fset31 = generate_search_sets(FC, FC, 100)
    caps = {cp: synthetic_capture(**kw) for cp, kw in CAPTURES.items()}
    cap = caps["normal"]
    cap_ri = torch.from_numpy(
        np.stack([cap.real, cap.imag], -1).astype(np.float32)).to(dev)
    cap2 = cap_ri.T.contiguous()
    n_cap = len(cap)

    def scan_inputs(fset):
        plan = xcorr_torch.scan_plan(n_cap, fset, FC, FC, 1.92e6)
        return (plan, torch.from_numpy(plan.tpl).to(dev),
                torch.from_numpy(plan.starts).to(dev))

    scan_err = {}
    for label, fset in (("31-hyp", fset31),
                        ("241-hyp", np.arange(-120, 121) * 5e3)):
        plan, tpl, starts = scan_inputs(fset)
        got = xcorr_torch.xcorr_fold(cap2, tpl, starts, plan.n_comb_xc)
        want = xcorr_torch.xcorr_fold_plain(cap2, tpl, starts, plan.n_comb_xc
                                            ).view(len(fset), 3, -1
                                                   ).permute(1, 2, 0)
        torch.cuda.synchronize()
        err = (got - want).abs()
        tol = 1e-5 * want.abs() + 1e-6 * want.abs().max()
        scan_err[label] = float(err.max())
        check(bool((err <= tol).all()),
              f"xcorr_fold {label} n_f={len(fset)} n_comb={plan.n_comb_xc}: "
              f"max abs err {float(err.max()):.3e} (tolerance rtol 1e-5 + "
              f"atol 1e-6 * max {float(want.abs().max()):.3e})")

    # The MIB batch of 64 candidates: the capture's detected cell at 64
    # timings and frequencies around it.
    plan31, tpl31, starts31 = scan_inputs(fset31)
    packed, single, _ = xcorr_torch.xcorr_core(cap2, plan31, 2)
    peaks = peaks_to_cells(peak_search_device(
        packed, single, r_th1_normalized(plan31.n_comb_xc, 2), 2).cpu().numpy(),
        fset31, FC, FC)
    synced = [c for c in sss_foe_batch(peaks, cap_ri, 3.0)
              if c.n_id_1 >= 0 and c.cp_type == "normal"]
    check(bool(synced), "the normal-CP capture yields a synced candidate")
    cells64 = [dataclasses.replace(synced[0],
                                   frame_start=synced[0].frame_start + 0.37 * i,
                                   freq_fine=synced[0].freq_fine + 3.0 * i)
               for i in range(64)]
    mplan = mib_torch.mib_plan(cells64, n_cap)
    demod_args = mib_torch.fd_demod_inputs(mplan, dev)
    n_win = demod_args[0].shape[0]
    got = fd_demod(cap_ri, *demod_args)
    want = fd_demod_plain(cap_ri, *demod_args)
    fd_err = float((got - want).abs().max())
    fd_max = float(want.abs().max())
    check(fd_err <= 1e-4 * fd_max,
          f"fd_demod N={n_win}: max abs err {fd_err:.3e} (tolerance "
          f"1e-4 * max {fd_max:.3e})")

    stages = {}
    mib_torch.run(cap_ri, mplan, "hex", stages=stages)
    llr_tl = stages["llr"].reshape(10, 12, -1).contiguous()
    n_cw = llr_tl.shape[2]
    bits = viterbi.viterbi_tl(llr_tl)
    bits_plain = viterbi.viterbi_tl_plain(llr_tl)
    vit_err = float((bits - bits_plain).abs().max())
    bad = (bits != bits_plain).any(dim=0).nonzero().flatten()
    check(len(bad) == 0,
          f"viterbi L={n_cw}: {len(bad)} codeword(s) differ from the plain "
          "version (bits must be identical)")
    if len(bad):
        m, _ = viterbi.viterbi_metrics_plain(llr_tl)
        top2 = torch.diagonal(m, dim1=1, dim2=2).topk(2, dim=1).values
        gap = (top2[:, 0] - top2[:, 1])[bad]
        print(f"  plain winner-vs-runner-up gap at the mismatching lanes: "
              f"{gap.cpu().numpy().tolist()[:16]}")

    # The wrappers refuse what the kernels do not take.
    def refuses(fn) -> bool:
        try:
            fn()
        except ValueError:
            return True
        return False

    check(refuses(lambda: xcorr_torch.xcorr_fold(
        cap2.double(), tpl31, starts31, plan31.n_comb_xc))
          and refuses(lambda: fd_demod(cap_ri, demod_args[0][::2],
                                       *demod_args[1:]))
          and refuses(lambda: viterbi.viterbi_tl(llr_tl[:, :6])),
          "the kernel wrappers raise on a bad dtype, shape or layout")

    # ---- 3. the main path, with the launch counts.
    truth = {cp: (3 * kw["n_id_1"] + kw["n_id_2"], kw["cp_type"],
                  kw["n_rb_dl"], kw["sfn_start"], 1)
             for cp, kw in CAPTURES.items()}
    found = {}
    kernels.reset_launches()
    for cp, c in caps.items():
        found[cp] = dedup(cell_search(c, FC, f_search_set=fset31))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"main path launches: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} time(s) on the main path")
    for cp, cells in found.items():
        got = [(c.n_id_cell(), c.cp_type, c.n_rb_dl, c.sfn, c.n_ports)
               for c in cells]
        check(truth[cp] in got, f"{cp} CP capture: found {got}, want "
              f"(cell, cp, n_rb_dl, sfn, n_ports) = {truth[cp]}")
        ref = dedup(cell_search(caps[cp], FC, f_search_set=fset31,
                                device="cpu"))
        same = len(ref) == len(cells) and all(
            [getattr(a, f) for f in CELL_FIELDS]
            == [getattr(b, f) for f in CELL_FIELDS]
            and abs(a.freq_superfine - b.freq_superfine) < 0.5
            for a, b in zip(cells, ref))
        check(same, f"{cp} CP capture: the card's cells equal the plain "
              "versions' on the CPU (freq_superfine within 0.5 Hz)")

    # ---- 4. timing.
    t_scan = cuda_ms(lambda: xcorr_torch.xcorr_fold(cap2, tpl31, starts31,
                                                     plan31.n_comb_xc))
    t_scan_plain = cuda_ms(lambda: xcorr_torch.xcorr_fold_plain(
        cap2, tpl31, starts31, plan31.n_comb_xc))
    n_ch = 3 * len(fset31)
    w_re = tpl31[:, :, 0].reshape(n_ch, -1)
    w_im = tpl31[:, :, 1].reshape(n_ch, -1)
    weight = torch.cat([torch.stack([w_re, -w_im], 1),
                        torch.stack([w_im, w_re], 1)], 0)
    t_conv = cuda_ms(lambda: torch.nn.functional.conv1d(cap2[None], weight))
    print(f"scan yardstick (partial: F.conv1d correlation only, no fold): "
          f"{t_conv:.4f} ms")
    t_fd = cuda_ms(lambda: fd_demod(cap_ri, *demod_args))
    t_fd_plain = cuda_ms(lambda: fd_demod_plain(cap_ri, *demod_args))
    t_vit = cuda_ms(lambda: viterbi.viterbi_tl(llr_tl))
    t_vit_plain = cuda_ms(lambda: viterbi.viterbi_tl_plain(llr_tl))
    e2e = {}
    for cp in caps:
        e2e[cp] = host_ms(lambda: cell_search(caps[cp], FC,
                                              f_search_set=fset31))
        print(f"end to end: cell_search {cp} CP, 31 hypotheses, 80 ms "
              f"capture: {e2e[cp]:.3f} ms per capture (median of {REPS})")
        stage_breakdown(caps[cp], cp, fset31)
    device_busy(lambda: cell_search(caps["normal"], FC, f_search_set=fset31),
                e2e["normal"])
    cli = subprocess.run(
        [sys.executable, "-m", "lte_cell_scanner_tpu_torch.search.cli",
         "--freq-start", "739e6", "--simulate", "--brief"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    print(cli.stdout.strip())
    check(cli.returncode == 0 and any(
        line.split()[:1] == ["271"] for line in cli.stdout.splitlines()),
          "the CLI (--simulate, on the card) finds cell 271")

    n_f, n_comb = len(fset31), plan31.n_comb_xc
    scan_b = bound(n_ch * 9600 * n_comb * (137 * 8 + 3),
                   4 * (2 * n_cap + n_ch * 2 * 137 + n_f * n_comb
                        + n_ch * 9600))
    fd_b = bound(n_win * (128 * 72 * 8 + 128 * 8 + 72 * 10),
                 8 * n_cap + n_win * 4 * 4 + 4 * (2 * 128 * 72 + 72)
                 + n_win * 72 * 8)
    n_steps = llr_tl.shape[0]
    vit_b = bound(n_cw * n_steps * (2 * 1024 * 24 + 64 * 64 * 16 * 2
                                    + 64 * 16 * 2),
                  4 * (llr_tl.numel() + 12 * 1024 + 1024 * 4 + 40 * n_cw))
    rows = [
        dict(name="xcorr_fold", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/xcorr_fold.cu",
             replaces="lte_cell_scanner_tpu/ops/xcorr_pallas.py:124 (K1), "
                      "lte_cell_scanner_tpu/ops/xcorr_pallas.py:51 (K2)",
             launches=launches["xcorr_fold"], max_abs_err=scan_err["31-hyp"],
             ms=t_scan, plain_ms=t_scan_plain, bound_ms=scan_b[0],
             bound_by=scan_b[1], library_ms=None),
        dict(name="fd_demod", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/fd_demod.cu",
             replaces="lte_cell_scanner_tpu/ops/fd_demod_pallas.py:58 (K4)",
             launches=launches["fd_demod"], max_abs_err=fd_err, ms=t_fd,
             plain_ms=t_fd_plain, bound_ms=fd_b[0], bound_by=fd_b[1],
             library_ms=None),
        dict(name="viterbi", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/viterbi.cu",
             replaces="lte_cell_scanner_tpu/models/viterbi_pallas.py:63 (K5)",
             launches=launches["viterbi"],
             max_abs_err=vit_err, ms=t_vit,
             plain_ms=t_vit_plain, bound_ms=vit_b[0], bound_by=vit_b[1],
             library_ms=None),
    ]
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:",
              file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
