#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lte_cell_scanner_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Nine paths of the port run on the card: the cell search on one capture
(search/cell_search.py), the batched tracker engine (tracker/,
LTETracker), the tools (tools/: bench_scan, bench_viterbi, bench_decode,
bench_demod, bench_tracker, mc_search, bench_wideband), the batched fc
sweep (parallel/fc_sweep.py, search/pipeline.py, the CLI's
--batch-sweep), the wideband front end (io/frontend.py,
search/wideband.py, the CLI's --wideband), the multi-device paths
(parallel/: the sweeps' cap axis, the (seq, hyp)-sharded scan, the
torch.distributed collective path, the tracker cycle's cell axis), the
tracker CLI's file playback (tracker/cli.py --load), the tracker with
the C++ sample feeder and the CE tap (tracker/native_feeder.py), and the
float64 host path (cell_search(backend="numpy"), the host CellTracker
behind LTETracker(batch=False), the engine on sample-carrying PDUs and the
full TFG grid of ops/mib_torch.py::extract_tfg_batch).
Phases; the script exits non-zero if any fails:

1. Print the card (nvidia-smi name and power limit), build the CUDA
   sources from csrc/ (one nvcc each, started together) and the C++
   feeder (native/feeder.cpp, g++, into build/native/).
2. Hold each kernel against its plain PyTorch version at the shapes of its
   path: the scan at 80 ms and the full 31-hypothesis grid (plus an
   extreme +-600 kHz grid), in both layouts (the 2x2 kernel K1 and the
   Karatsuba kernel K3, both 3xTF32 on the tensor cores, K3 also against
   K1); both also at 1 and 17 hypotheses, on the unsorted +-600 kHz grid
   and on a capture of fewer than 15 folds; K1 on bf16-rounded inputs
   (exact products: rtol 1e-6) and K3's bf16 mode (one bf16 product per
   tap) at 31 hypotheses; the error of each at 31 hypotheses against a
   float64 reference beside the plain version's and the 3xTF32
   emulation's, with K1's peak-table margin to a tie; the symbol demod's
   MIB mode and the Viterbi
   decoder at the MIB batch of 64 candidates (25,216 windows, 768
   codewords); the symbol demod's stream mode and the Viterbi decoder on
   the inputs of a real tracker cycle at full width (96 cells x 300 ms of
   signal: 403,200 windows, ~720 codewords), recorded from the capacity
   engine's warm-up cycles; both demod modes at edge window starts (0,
   every start mod 128, the last row, past the end of the samples) and the
   Viterbi decoder on tie-heavy integer LLRs (bits identical).
3. Drive each path with the kernels' launch counts set to 0 just before
   and read just after: cell_search on simulator captures at 739 MHz with
   the 31-hypothesis grid (normal CP / 50 RB and extended CP / 100 RB),
   checked against the simulator's truth and the same search through the
   plain versions on the CPU; LTETracker on 400 blocks of a simulated cell
   (cell 271), checked against the same run on the CPU; both CLIs; the
   tools path: bench_scan in the tea, roll and tea3 layouts and in bf16
   in tea and tea3 on both captures (each peak table must equal tea's in
   the same precision), bench_viterbi (bits equal
   to the host decoder), bench_decode (the synced candidates, replicated
   to a batch of 64, decode as they do alone; and the same batch over 32
   stacked captures), profile_pipeline (64 carriers in chunks of 32),
   bench_demod at the tracker
   path's median stream launch size, 1,050 and 403,200 windows,
   bench_tracker at 8 cells x 0.6 s (without its device-bound replay,
   which the capacity phase takes), and mc_search at the settings
   of the JAX package's MC_r05.json (ppm 10, seed 0, 50 trials at -10 and
   -12 dB): 50/50 detections and MIB decodes at -10 dB, no false cell, and
   at least 36/50 at -12 dB; mc_search --backend numpy (the float64 host
   chain) at the JAX tests/test_mc_floor.py point (8 trials, -10 dB, seed
   10, ppm 10): at least 5 detections and 5 MIB decodes, at most 1 false
   cell, the torch backend's counts on the same trials beside it; the
   sweep path: 64 carriers (739.0-745.3 MHz,
   31 hypotheses, a quarter each cells 271, 503 and 90 and an empty
   carrier, every other one on the E4000 tuner's carrier, as uint8 radio
   planes) in one batch, K1 launched once over the 64-capture stack and
   checked against its plain version; its cells against the serial
   cell_search on every capture and a device="cpu" run on 4; the
   pipelined sweep of 128 carriers in chunks of 32 (K1 once per chunk)
   against the whole stack; share_banks; full peak tables (max_peaks=1)
   redone on the card; the CLI's --batch-sweep
   --sweep-batch 32 with --simulate -r, then --load; the sweep's ms per
   carrier (serial, whole stack, pipelined; host clock, median of 5), K1
   batched against 64 one-capture launches (CUDA events) and the whole
   stack's device-busy share; bench_wideband at 16 and 296 carriers; the
   wideband path: one 30.72 Msps recording of 80 ms around 739 MHz with
   four planted cells (271 at 741.0, 503 at 732.7, 90 at 726.9 and 302 at
   753.8 MHz, the top usable carrier), its 296 carriers channelized in one
   call (held to the float64 decimation and the per-carrier form) and
   swept as one stack (K1 once over 296 captures, checked against its
   plain version), every plant decoded as planted and no cell more than 1
   MHz from one, the plants and two empty carriers equal to a
   float64-channelized sweep and a device="cpu" run, share_banks, the
   CLI's --wideband on an .it file and on raw bytes; the wideband sweep's
   ms per carrier and its stages (host clock, median of 5), the
   channelizer and K1 at B = 296 against their bounds (CUDA events), peak
   device memory and the device-busy share; the multi path (the device
   count printed): the 64-carrier whole stack over every visible card and
   over two shards on cuda:0, the 128 x 32 pipeline and the 296-carrier
   wideband sweep over two shards on cuda:0 (K1 once per shard, once per
   shard per chunk; every decoded cell equal to the one-shard run's),
   dryrun_multichip on ("cuda:0",) x 4 at (seq 2, hyp 2) (float32 tables
   within 1e-5 x max of the unsharded K1 scan), and a world-size-1 NCCL
   process group running the (seq 2, hyp 2) scan through all_reduce and
   all_gather; the whole stack's ms per carrier at 1 and 2 shards, K1 at
   B = 32 against B = 64 and the (seq, hyp) scan at (1,1), (2,1), (1,2)
   and (2,2) shards against the unsharded scan; dryrun_multichip also
   splits a tracker cycle of 8 cells over its 4 shards; the tracker cycle
   at the capacity run's full width (96 cells x 300 ms) with its cell axis
   split over two shards on cuda:0 and over every visible card, held to
   the one-device run (check_tracker_cells_sharded: demod, CE rows, ac_td
   history and FOE/TOE bit-equal, K4's stream mode launched once per
   shard), and its demod and stats programs timed unsplit and split
   (CUDA events).
4. Time each kernel, its plain version and its library yardstick (K1:
   F.conv1d of the 2x2 blocks; K3: the grouped F.conv1d of its three real
   correlations; K4: torch.fft.fft and a dense f32 matmul, both partial;
   K1 and both K3 modes also at 241 hypotheses, in one call: the Karatsuba
   trade) with
   CUDA events around single calls (3 warm-up calls, median of 20), and
   the end-to-end
   search on the host clock (median of 20); time the tracker's capacity run
   (96 replicated cells, 300 ms cycles, host clock ending in a sync,
   median cycle), its stage split and its device-busy share; its
   device-bound capacity (tools/bench_tracker.py::device_bound: the last
   timed cycle's demod and stats programs and MIB decode, tapped and
   replayed from cloned arguments in CUDA graphs, eagerly and under the
   profiler; the graph replay, the eager replay and the tapped cycle must
   be bit-equal; the replays' launches are printed on their own line and
   stay out of the launch counts); and the host cost of a launch's device
   guard.
5. The tracker as its users run it, with the launch counts set to 0 just
   before and read just after each drive: the CLI playing the tracker's
   simulated cell (2.1 s, noise power 0.01) from an .it file and from raw
   rtl_sdr bytes (--load [--rtl-sdr-format] --no-repeat --noise-power
   --blocks 400, subprocesses), then in this process with --feeder native
   --expert --g2 1.5: cell 271 acquired and its status rows printed; the
   tracker with the C++ feeder against the Python feeder on the card
   (cells, MIB decodes; every descriptor against a Python feeder fed the
   same blocks and cell states), both with a CE tap, the Python
   run's taps against a CPU run's (the same symbols, CE within one
   float16 step); the feeders' host ms per block at 1 and 96 cells.
6. The host path, with the launch counts set to 0 just before the drive
   and read just after: cell_search(backend="numpy") on both captures
   with the 31-hypothesis grid in hex and in 2stage (the card's cells and
   MIB fields, freq_superfine within 0.5 Hz); extract_tfg_batch over 64
   replicas of each capture's synced candidate (K4's MIB mode once per
   CP group, 54,656 and 46,848 windows: the full 854/732-row grid, held
   to the float64 host extract_tfg per cell, timestamps within 1e-9 and
   the grid within 2e-3 x max); LTETracker(batch=False,
   backend="torch") on 400 blocks of the tracker's cell (its searcher
   launches K1, K4 and K5; cell 271 at health 1.0 with more than 10 MIB
   decodes; the same events, FO and frame timing as a device="cpu" run
   and as backend="numpy"); the engine on sample-carrying PDUs from the
   Python and the C++ feeder over 300 blocks (K4's stream mode over the
   windows laid end to end; the same cells as phase 5's descriptor-mode
   run, its CE taps within one float16 step). Then K4 at both new shapes
   against its plain version, and the times: the float64 chain per
   capture against the card's search (host clock, median of 5),
   extract_tfg_batch at B = 64 and its K4 launch against the byte bound
   (CUDA events), the host tracker's ms per block against the engine's.

Each kernel's ``launches`` in the kernels line is the sum over the nine
paths' runs, ``launches_by_path`` the split. The line before the last is
{"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits with 2 and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores, FMA = 2
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 on the tensor cores
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
# The tracker's simulated cell (tests/test_batch_tracker.py::sim_signal):
# cell 271, 1 port, normal CP, 50 RB, at +4 kHz.
TRACKER_SIG = dict(n_id_1=90, n_id_2=1, snr_db=15, freq_offset=4e3,
                   sfn_start=0, seed=5)
# Capacity run at full width (the JAX package's tools/bench_tracker.py
# measure(cells=96, chunk_ms=300)): 96 replicas of the tracked cell, 300 ms
# of signal per engine cycle; 2 warm-up cycles, 5 timed, 1 profiled.
CAP_CELLS, CHUNK_MS = 96, 300.0
WARM_CYCLES, TIMED_CYCLES, PROFILED_CYCLES = 2, 5, 1
# Each path's kernels: a path's run must launch every one of them.
SEARCH_KERNELS = ("xcorr_fold", "fd_demod", "viterbi")
TRACKER_KERNELS = ("fd_demod_stream", "viterbi")
TOOLS_KERNELS = ("xcorr_fold", "xcorr_fold3", "xcorr_fold3_bf16", "fd_demod",
                 "fd_demod_stream", "viterbi")
# The Monte-Carlo floor of the JAX package's MC_r05.json: 50 trials per
# point, ppm 10, seed 0; there 50/50 at -10 dB and 43/50 at -12 dB.
MC_SNRS, MC_TRIALS, MC_REF = (-10.0, -12.0), 50, {-10.0: 50, -12.0: 43}
MC_MIN = {-10.0: 50, -12.0: 36}
# The float64 host chain's floor point: the JAX package's
# tests/test_mc_floor.py at -10 dB (8 trials, seed 10, ppm 10) and its
# bounds: at least 5 detections and 5 MIB decodes, at most 1 false cell.
MC64_ARGS = ["--trials", "8", "--snr-db", "-10", "--seed", "10",
             "--ppm", "10"]
MC64_MIN, MC64_MAX_FALSE = 5, 1

# The sweep path: B = 64 carriers (739.0-745.3 MHz) in one batch, and the
# pipeline at 128 carriers (739.0-751.7 MHz) in chunks of 32; the serial
# loop timed on 16 of the captures; SWEEP_REPS timed runs each.
SWEEP_B, SWEEP_PIPE, SWEEP_REPS, SWEEP_SEED = 64, (128, 32), 5, 11
SWEEP_CELL90 = dict(n_id_1=30, n_id_2=0, snr_db=15.0, freq_offset=6e3,
                    n_rb_dl=75, seed=7)
SWEEP_KERNELS = ("xcorr_fold", "fd_demod", "viterbi")

# The wideband path (search/wideband.py): one 30.72 Msps recording of 80 ms
# (n_wide = (153600 + 10) x 16 samples, the channelizer's FIR start-up
# included) centred at 739 MHz; all 296 carriers of its 100 kHz raster
# (724.3-753.8 MHz; ppm 100: 31 hypotheses) channelized in one call and
# swept as one stack. Four cells are planted, each a 90-subframe simulator
# capture upsampled x16 (interpft) and shifted to its carrier; the last on
# the top usable carrier, at the FIR's edge. Each plant: (carrier,
# synthetic_capture arguments, decoded (cell, CP, nRB, ports, SFN, PHICH
# duration and resource), planted frequency offset).
WB_FS, WB_CENTER, WB_DECIM = 30.72e6, 739e6, 16
WB_N = (153600 + 10) * WB_DECIM
WB_PLANTS = (
    (741.0e6, CAPTURES["normal"], (271, "normal", 50, 1, 64, "normal", 1.0)),
    (732.7e6, CAPTURES["extended"],
     (503, "extended", 100, 1, 64, "normal", 1.0)),
    (726.9e6, dict(SWEEP_CELL90, sfn_start=100),
     (90, "normal", 75, 1, 100, "normal", 1.0)),
    (753.8e6, dict(n_id_1=100, n_id_2=2, cp_type="normal", snr_db=10.0,
                   freq_offset=-3e3, n_rb_dl=25, sfn_start=300, seed=13),
     (302, "normal", 25, 1, 300, "normal", 1.0)))
WB_EMPTY = (739.0e6, 745.5e6)     # more than 1 MHz from every plant

# The tracker as its users run it (LTE-Tracker): the CLI plays a recording
# of the tracker's simulated cell (2.1 s, so that --no-repeat --blocks 400
# prints two status frames) with added noise, from an .it file and from raw
# rtl_sdr bytes; trackers with the Python and the C++ feeder and a CE tap
# on TAP_BLOCKS blocks; the feeders' host time per block (median of
# FEEDER_BLOCKS after FEEDER_WARM) at 1 and 96 cells of distinct IDs.
PLAY_SUBFRAMES, PLAY_NOISE, PLAY_BLOCKS = 2100, 0.01, 400
PLAYBACK_KERNELS = ("xcorr_fold", "fd_demod", "fd_demod_stream", "viterbi")
TAP_BLOCKS, FEEDER_BLOCKS, FEEDER_WARM = 300, 24, 3
# The CE tap's tolerance: one float16 step (rtol 1e-3 + atol 1e-3 x max),
# that of tests/test_torch_tracker_engine.py::test_ce_tap_matches_jax.
CE_RTOL = 1e-3

# The host path (the float64 chain, the host CellTracker, the engine on
# sample-carrying PDUs and the full TFG grid): HOST_TFG_B replicas per CP
# group for extract_tfg_batch, the float64 search timed HOST_REPS times;
# a noise-power tap between the engine's two PDU modes within
# HOST_NP_RTOL (tests/test_torch_host_tracker.py).
HOST_KERNELS = ("xcorr_fold", "fd_demod", "fd_demod_stream", "viterbi")
HOST_TFG_B, HOST_REPS, HOST_NP_RTOL = 64, 5, 1e-2
HOST_BLOCKS = 400          # the host tracker's runs, as the tracker path


def tapped(slot: int, sym: int) -> bool:
    """The CE tap's symbols (tests/test_torch_tracker_engine.py::_tapped):
    slots no other consumer reads, so the tap adds consumers."""
    return slot in (3, 13) and sym in (0, 2, 4)


# Flops of csrc/fd_demod.cu's 128-point FFT per window: 8 in-register
# DFT_16 (188 flops each: 16 complex adds, 6 twiddle products, two DFT_8
# of 60), 8 x 15 W128 twiddle products (6 flops), 16 DFT_8.
FFT128_FLOPS = 8 * 188 + 8 * 15 * 6 + 16 * 60

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


def host_ms_n(fn, n: int):
    """(median, runs): wall milliseconds of fn() ending in a device sync,
    n runs after one warm-up run."""
    import torch

    fn()
    runs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(round((time.perf_counter() - t0) * 1e3, 3))
    return float(np.median(runs)), runs


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


def device_busy(fn, wall_ms: float, warm: bool = True) -> None:
    """Device time of one call under torch.profiler against the unprofiled
    wall time: the device's busy share, and the kernels that fill it.
    ``warm`` runs fn once unprofiled first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
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


def edge_starts(n_samples: int, rng) -> np.ndarray:
    """Symbol-demod window starts at the edges: 0, every b = start mod 128
    (random rows), the last row and windows running past the end of the
    samples (their rows clamp and read the pad)."""
    n_rows = -(-n_samples // 128)
    every_b = 128 * rng.integers(0, n_rows - 1, 128) + np.arange(128)
    last = [n_samples - 128, n_samples - 64, n_samples - 1,
            128 * (n_rows - 1), n_samples + 3, n_samples + 200]
    return np.concatenate([[0], every_b, last]).astype(np.int32)


def fd_yardsticks(n: int):
    """K4's partial yardsticks at N windows, in ms: one torch.fft.fft over
    (N, 128) complex64 (cuFFT) and the dense real-block f32 product
    (N, 256) @ (256, 144). Timed here only; the port never calls them."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, 128, dtype=torch.complex64, device="cuda",
                    generator=gen)
    t_fft = cuda_ms(lambda: torch.fft.fft(x))
    del x
    a = torch.randn(n, 256, device="cuda", generator=gen)
    w = torch.randn(256, 144, device="cuda", generator=gen)
    t_mm = cuda_ms(lambda: a @ w)
    return t_fft, t_mm


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops = flops / peak * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def scan_tc_flops(n_f: int, n_comb: int) -> float:
    """Flops of the scan's function on the tensor cores: 3 n_f channels x
    9600 lags x n_comb folds x 137 complex MACs (8 real flops), three TF32
    products each (3xTF32). What the kernel runs beyond this (its groups'
    fold-start spread, a padded group's zero templates) is not counted."""
    return 3.0 * 3 * n_f * 9600 * n_comb * 137 * 8


def scan3_tc_flops(n_f: int, n_comb: int, products: int) -> float:
    """Flops of K3's function on the tensor cores: 3 n_f channels x 9600
    lags x n_comb folds x 137 complex taps, three real MACs each (6
    flops), times the products a real MAC takes (3 for 3xTF32, 1 in
    bf16)."""
    return 3.0 * n_f * 9600 * n_comb * 137 * 6 * products


def k3_accuracy(xcorr_torch, cap3, tpl3, starts, n_comb):
    """K3's (float32 mode) error on one scan against a float64 reference
    of the same function (the plain version in float64 on the CPU),
    beside the float32 plain version's (card and CPU) and the 3xTF32
    emulation's (CPU). Prints them; returns the kernel's error."""
    n_f = tpl3.shape[0]
    c3, t3, st = cap3.cpu(), tpl3.cpu(), starts.cpu()

    def as3(fold):
        return fold.view(n_f, 3, -1).permute(1, 2, 0).double().cpu()

    ref = as3(xcorr_torch.xcorr_fold3_plain(c3.double(), t3.double(), st,
                                            n_comb))
    routes = {
        "kernel (card)": xcorr_torch.xcorr_fold3(cap3, tpl3, starts, n_comb
                                                 ).double().cpu(),
        "plain f32 (card)": as3(xcorr_torch.xcorr_fold3_plain(
            cap3, tpl3, starts, n_comb)),
        "plain f32 (CPU)": as3(xcorr_torch.xcorr_fold3_plain(c3, t3, st,
                                                             n_comb)),
        "3xTF32 emulation (CPU)": as3(xcorr_torch.xcorr_fold3_3xtf32_plain(
            c3, t3, st, n_comb)),
    }
    errs = {k: float((v - ref).abs().max()) for k, v in routes.items()}
    print(f"K3 max abs error against float64 (max |ref| "
          f"{float(ref.abs().max()):.4e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs["kernel (card)"]


def k1_accuracy(xcorr_torch, cap2, plan, single, packed, table, ds):
    """K1's error on the 31-hypothesis scan against a float64 reference
    of the same function (the plain version in float64 on the CPU), beside
    the float32 plain version's (card and CPU) and the 3xTF32 emulation's
    (CPU: the kernel's products, summed in float32). Then the peak table's
    margin: over its peaks, the smallest gap in the reference between the
    winner and the runner-up of the two argmaxes that place a peak, the
    hypothesis at the peak's lag and the lag within +-ds at the peak's
    hypothesis. Prints both; returns the kernel's error."""
    import torch

    n_f = plan.tpl.shape[0]
    tpl, starts = torch.from_numpy(plan.tpl), torch.from_numpy(plan.starts)
    cpu = cap2.cpu()

    def as3(fold):
        return fold.view(n_f, 3, -1).permute(1, 2, 0).double().cpu()

    ref = as3(xcorr_torch.xcorr_fold_plain(cpu.double(), tpl.double(),
                                           starts, plan.n_comb_xc))
    routes = {
        "kernel (card)": single.double().cpu(),
        "plain f32 (card)": as3(xcorr_torch.xcorr_fold_plain(
            cap2, tpl.to(cap2.device), starts.to(cap2.device),
            plan.n_comb_xc)),
        "plain f32 (CPU)": as3(xcorr_torch.xcorr_fold_plain(
            cpu, tpl, starts, plan.n_comb_xc)),
        "3xTF32 emulation (CPU)": as3(xcorr_torch.xcorr_fold_3xtf32_plain(
            cpu, tpl, starts, plan.n_comb_xc)),
    }
    errs = {k: float((v - ref).abs().max()) for k, v in routes.items()}
    print(f"K1 max abs error against float64 (max |ref| "
          f"{float(ref.abs().max()):.4e}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    inc = xcorr_torch._delay_spread(ref, ds)
    coll = packed[0:3].double().cpu()
    gaps = []
    for pw, ind_r, foi, n2 in table.double().cpu().numpy():
        if pw <= 0:
            break
        n2, foi = int(n2), int(foi)
        win = (int(ind_r) + np.arange(-ds, ds + 1)) % 9600
        ind = int(win[np.argmin(np.abs(coll[n2, win].numpy() - pw))])
        top = torch.topk(inc[n2, ind], 2).values
        gaps.append(float(top[0] - top[1]))
        lags = (ind + np.arange(-ds, ds + 1)) % 9600
        top = torch.topk(ref[n2, lags, foi], 2).values
        gaps.append(float(top[0] - top[1]))
    print(f"K1 peak-table margin: smallest winner - runner-up gap over "
          f"{len(gaps) // 2} peaks {min(gaps):.4e}, "
          f"{min(gaps) / errs['kernel (card)']:.1f}x the kernel's error")
    return errs["kernel (card)"]


def guard_us(dev) -> tuple:
    """Host microseconds per enter and exit of ``torch.cuda.device(dev)``
    and of ``launch_device(dev)`` (a no-op when dev is current), median of
    5 runs of 20,000."""
    import torch
    from lte_cell_scanner_tpu_torch.utils.device import launch_device

    out = []
    for ctx in (torch.cuda.device, launch_device):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(20000):
                with ctx(dev):
                    pass
            runs.append((time.perf_counter() - t0) / 20000 * 1e6)
        out.append(float(np.median(runs)))
    return tuple(out)


def harvest_pdus(n_pdus: int):
    """Run the tracker once on the card and record the descriptor PDUs
    its one tracked cell receives, plus the raw uint8 blocks they index
    into (the JAX package's tools/bench_tracker.py::_collect_pdus)."""
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                            playback_source)
    from lte_cell_scanner_tpu_torch.tracker.state import TrackedCell

    # 14,000 symbols per second of signal, 192 blocks per second, plus
    # ~0.4 s for the searcher to acquire the cell.
    n_blocks = int(np.ceil(n_pdus / 14000 * 192)) + 80
    sig = synthetic_capture(n_subframes=n_blocks * 10000 // 1920 + 1,
                            **TRACKER_SIG)
    pdus, raw = [], []
    orig_push = TrackedCell.push_pdu

    def tap(self, pdu):
        pdus.append(copy.copy(pdu))
        orig_push(self, pdu)

    def source():
        for blk in playback_source(sig):
            raw.append(blk)
            yield blk

    trk = LTETracker(FC, initial_freq_offset=4000.0, engine_every=20)
    TrackedCell.push_pdu = tap
    try:
        trk.run(source(), max_blocks=n_blocks)
    finally:
        TrackedCell.push_pdu = orig_push
    return pdus, raw, trk.cells


class CapacityRun:
    """CAP_CELLS replicas of one tracked cell (distinct serials, never
    dropped) on one engine, fed CHUNK_MS of harvested PDUs per cycle, so
    the full locked-tracker path runs: demod, stats, MIB decodes."""

    STAGES = (("_dispatch_demod", "demod dispatch"),
              ("_host_route", "host route"),
              ("_dispatch_stats_dispatch", "stats"),
              ("_ingest_demod", "ingest"),
              ("_stats_finish", "stats"),
              ("_finalize", "finalize+MIB"))

    def __init__(self, pdus, raw, proto):
        from lte_cell_scanner_tpu_torch.tracker.batch_runtime import (
            BatchTrackerEngine)
        from lte_cell_scanner_tpu_torch.tracker.state import (GlobalState,
                                                              TrackedCell)

        state = GlobalState(fc_requested=FC, fc_programmed=FC,
                            fs_programmed=1.92e6, frequency_offset=4000.0)
        self.cells = [TrackedCell(
            n_id_cell=proto.n_id_cell, n_ports=proto.n_ports,
            cp_type=proto.cp_type, n_rb_dl=proto.n_rb_dl,
            phich_duration=proto.phich_duration,
            phich_resource=proto.phich_resource,
            frame_timing=proto.frame_timing, serial_num=m,
            drop_threshold=float("inf")) for m in range(CAP_CELLS)]
        self.engine = BatchTrackerEngine(state)
        for blk in raw:
            self.engine.push_raw(blk)
        self.pdus = pdus
        self.fed = 0
        self.chunk = int(CHUNK_MS / 1000 * proto.n_symb_dl * 2 * 1000)
        self.signal_s = self.chunk / (proto.n_symb_dl * 2 * 1000)
        # Host seconds per stage in the current cycle (no extra syncs: a
        # stage that waits for a device result carries the wait).
        self.stage_s = {}
        for attr, label in self.STAGES:
            setattr(self.engine, attr,
                    self._timed(label, getattr(self.engine, attr)))

    def _timed(self, label, fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.stage_s[label] = (self.stage_s.get(label, 0.0)
                                       + time.perf_counter() - t0)
        return run

    def cycle(self) -> None:
        hi = self.fed + self.chunk
        if hi > len(self.pdus):
            raise RuntimeError("capacity run: harvested PDUs exhausted")
        for c in self.cells:
            c.fifo.extend(self.pdus[self.fed:hi])
        self.stage_s = {}
        self.engine.process_all(self.cells)
        self.fed = hi


def tools_path(caps, demod_sizes) -> dict:
    """The tools path, each tool called in-process through its ``main``
    (``measure`` for bench_tracker) as a user would; every tool prints
    its JSON line. Returns the tools' results by name."""
    from lte_cell_scanner_tpu_torch.io.itfile import save_it
    from lte_cell_scanner_tpu_torch.tools import (bench_decode, bench_demod,
                                                  bench_scan, bench_tracker,
                                                  bench_viterbi,
                                                  bench_wideband, mc_search,
                                                  profile_pipeline)

    out = {}
    # bench_scan reads a capture from an .it file (the reference's format).
    cap_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(cap_dir, exist_ok=True)
    paths = {}
    for cp, cap in caps.items():
        paths[cp] = os.path.join(cap_dir, f"capbuf_{cp}.it")
        save_it(paths[cp], {"capbuf": cap, "fc": np.array([FC])})
        scans = {(layout, prec): bench_scan.main([
            "--layout", layout, "--precision", prec, "--iters", "20",
            "--capture", paths[cp]])
            for layout, prec in (("tea", "f32"), ("roll", "f32"),
                                 ("tea3", "f32"), ("tea", "bf16"),
                                 ("tea3", "bf16"))}
        # In bf16 the two layouts round different planes (tea3 rounds the
        # sum re+im as a plane of its own, as the JAX package does), so
        # their powers agree to bf16's precision (2^-8), not float32's.
        for (layout, prec), rtol in ((("roll", "f32"), 1e-5),
                                     (("tea3", "f32"), 1e-5),
                                     (("tea3", "bf16"), 1e-2)):
            ref = np.array(scans[("tea", prec)]["peaks"])
            got = np.array(scans[(layout, prec)]["peaks"])
            check(np.array_equal(got[:, 1:], ref[:, 1:])
                  and np.allclose(got[:, 0], ref[:, 0], rtol=rtol, atol=0),
                  f"bench_scan {cp} CP {prec}: the {layout} peak table "
                  f"equals tea's ({int((ref[:, 0] > 0).sum())} peaks; lag, "
                  f"hypothesis and root exact, power within rtol {rtol:g})")
        out[f"scan_{cp}"] = scans
    try:
        vit = bench_viterbi.main(["--batch", "768", "--iters", "20"])
        check(vit["cuda_bits_equal"] and vit["plain_bits_equal"],
              "bench_viterbi: both variants' bits equal the host decoder's "
              "on 768 codewords")
        out["viterbi"] = vit
    except SystemExit as e:
        check(False, f"bench_viterbi: {e}")
    dec = bench_decode.main(["--iters", "10", "--capture", paths["normal"]])
    check(dec["b_candidates"] == 64 and dec["synced_decoded"] >= 1
          and dec["replicas_agree"] and dec["cells"] == [271],
          f"bench_decode: {dec['synced_decoded']} of {dec['n_synced']} "
          f"synced candidates decode their MIB, {dec['mib_decoded']} of the "
          f"batch of {dec['b_candidates']}, every replica as its original: "
          f"{dec['replicas_agree']}, cells {dec['cells']} (want >= 1, True, "
          "[271])")
    out["decode"] = dec
    # The batch of 64 over 32 stacked copies of the capture, as a sweep
    # hands the decode its captures: the same decodes.
    dec32 = bench_decode.main(["--iters", "10", "--b-cap", "32",
                               "--capture", paths["normal"]])
    check(dec32["b_captures"] == 32 and dec32["replicas_agree"]
          and dec32["mib_decoded"] == dec["mib_decoded"]
          and dec32["cells"] == dec["cells"],
          f"bench_decode --b-cap 32: {dec32['mib_decoded']} of "
          f"{dec32['b_candidates']} decode over 32 stacked captures, as over "
          f"one ({dec['mib_decoded']}); cells {dec32['cells']}")
    out["decode_b_cap"] = dec32
    prof = profile_pipeline.main(["--carriers", "64", "--batch", "32",
                                  "--reps", "2"])
    check(prof["cells"] == [271] and prof["carriers_with_cells"] == 64,
          f"profile_pipeline 64 x 32: cell 271 on "
          f"{prof['carriers_with_cells']} of 64 carriers, "
          f"{prof['value']:.3f} ms per carrier")
    out["profile_pipeline"] = prof
    # The channelizer at the tool's defaults (16 carriers) and at the full
    # band of a 30.72 Msps recording (296 carriers).
    for argv in ([], ["--carriers", "296"]):
        bw = bench_wideband.main(argv)
        check(bw["n_out"] == 153600 and bw["bank_ms"] > 0
              and bw["map_ms"] > 0,
              f"bench_wideband {' '.join(argv) or '(defaults)'}: "
              f"{bw['carriers']} carriers, bank {bw['bank_ms']:.4f} ms "
              f"({bw['value']:.5f} ms per carrier), map {bw['map_ms']:.3f} "
              f"ms ({bw['speedup_vs_map']:.1f}x)")
        out[f"wideband_{bw['carriers']}"] = bw
    try:
        out["demod"] = bench_demod.main([
            "--windows", ",".join(map(str, demod_sizes)), "--iters", "20"])
        check(True, "bench_demod: the stream kernel within 1e-4 x max of "
              f"its plain version at {demod_sizes} windows")
    except SystemExit as e:
        check(False, f"bench_demod: {e}")
    # Without the device-bound replay: its profiler run would slow the
    # launches of every path timed after this one (the capacity phase
    # takes the replay at full width, after the timings it could slow).
    trk = bench_tracker.measure(cells=8, seconds=0.6, replay=False)
    print(json.dumps(trk))
    check(trk["min_health"] == 1.0 and trk["mib_decodes"] > 0,
          f"bench_tracker 8 cells x 0.6 s: {trk['mib_decodes']} MIB "
          f"decodes, min health {trk['min_health']} (want > 0, 1.0)")
    out["tracker"] = trk
    art = mc_search.main(["--snr-sweep=" + ",".join(map(str, MC_SNRS)),
                          "--trials", str(MC_TRIALS), "--ppm", "10",
                          "--seed", "0"])
    for pt in art["points"]:
        snr = pt["snr_db"]
        print(f"mc_search {snr:+.0f} dB: detections {pt['detections']}/"
              f"{pt['trials']}, MIB {pt['mib_successes']}/{pt['trials']}, "
              f"false cells {pt['false_cells']}, freq err median "
              f"{pt['freq_err_med_hz']} Hz (MC_r05.json: {MC_REF[snr]}/50)")
        ok = min(pt["detections"], pt["mib_successes"]) >= MC_MIN[snr]
        if snr == -10.0:
            ok = ok and pt["false_cells"] == 0
        check(ok, f"mc_search {snr:+.0f} dB: at least {MC_MIN[snr]}/50 "
              "detections and MIB decodes"
              + (", no false cell" if snr == -10.0 else ""))
    out["mc"] = art
    mc64 = {}
    for backend in ("numpy", "torch"):
        t0 = time.perf_counter()
        mc64[backend] = mc_search.main(["--backend", backend, *MC64_ARGS])
        mc64[backend]["seconds"] = time.perf_counter() - t0
    print("mc_search " + " ".join(MC64_ARGS) + ": " + "; ".join(
        f"--backend {b}: detections {r['detections']}/{r['trials']}, MIB "
        f"{r['mib_successes']}, false cells {r['false_cells']} "
        f"({r['seconds']:.1f} s)" for b, r in mc64.items()))
    n64 = mc64["numpy"]
    check(n64["backend"] == "numpy" and n64["trials"] == 8
          and min(n64["detections"], n64["mib_successes"]) >= MC64_MIN
          and n64["false_cells"] <= MC64_MAX_FALSE,
          f"mc_search --backend numpy at -10 dB: at least {MC64_MIN}/8 "
          f"detections and MIB decodes, at most {MC64_MAX_FALSE} false cell "
          "(tests/test_mc_floor.py's bounds)")
    out["mc64"] = mc64
    return out


def sweep_stack(n_carriers: int):
    """The sweep's captures: n_carriers carriers from 739.0 MHz on the 100
    kHz raster, in turn a quarter each cell 271 (normal CP, 50 RB), cell
    503 (extended CP, 100 RB), cell 90 (normal CP, 75 RB at +6 kHz, seed
    7: the JAX package's tests/test_sharding.py:152) and an empty carrier
    of complex Gaussian noise; every other capture on the E4000 tuner's
    programmed carrier (+58 Hz). The four distinct captures are built once
    and go in as the radio's uint8 I/Q planes. Returns (planes (B, 2, n),
    fcs, fc_programmed, expected (cell, cp, n_rb_dl) per capture or
    None)."""
    from lte_cell_scanner_tpu_torch.io.capture import compute_fc_programmed
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.tools.profile_pipeline import \
        radio_planes

    rng = np.random.default_rng(SWEEP_SEED)
    n = 153600
    kinds = [
        (synthetic_capture(**CAPTURES["normal"]), (271, "normal", 50)),
        (synthetic_capture(**CAPTURES["extended"]), (503, "extended", 100)),
        (synthetic_capture(**SWEEP_CELL90), (90, "normal", 75)),
        ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3,
         None)]
    planes = [radio_planes(c) for c, _ in kinds]
    fcs = [FC + 100e3 * b for b in range(n_carriers)]
    fcp = [compute_fc_programmed(28.8e6, fc) + 58 if b % 2 else fc
           for b, fc in enumerate(fcs)]
    return (np.stack([planes[b % 4] for b in range(n_carriers)]), fcs, fcp,
            [kinds[b % 4][1] for b in range(n_carriers)])


def sweep_cells(per_cap):
    """Each capture's decoded cells as (cell, cp, n_rb_dl, n_ports, sfn,
    phich duration and resource) tuples: what a sweep must equal."""
    return [[(c.n_id_cell(), c.cp_type, c.n_rb_dl, c.n_ports, c.sfn,
              c.phich_duration, c.phich_resource) for c in cells]
            for cells in per_cap]


def sweep_path(fset, close) -> dict:
    """The batched sweep on the card, with the kernels' launch counts set
    to 0 just before each sweep and read just after: the whole-stack
    sweep at B = 64 (K1 launched once) and the pipelined sweep at 128 x 32
    (K1 once per chunk). Checks batched K1 against its plain version at B
    = 64; the whole-stack sweep against the serial cell_search on every
    capture and against a device="cpu" run on 4 captures; the pipeline
    against the whole-stack sweep of the same 128 captures; share_banks;
    full peak tables redone on the card;
    the CLI's --batch-sweep --sweep-batch 32, --record then --load.
    Times the three forms per carrier and K1 batched against 64 single
    launches; returns the whole-stack sweep to be profiled (its
    device-busy share) at the end of the script."""
    import tempfile

    import torch

    from lte_cell_scanner_tpu_torch import kernels
    from lte_cell_scanner_tpu_torch.ops import xcorr_torch
    from lte_cell_scanner_tpu_torch.parallel import fc_sweep
    from lte_cell_scanner_tpu_torch.search.cell_search import cell_search
    from lte_cell_scanner_tpu_torch.search.pipeline import \
        pipelined_search_sweep

    dev = torch.device("cuda")
    out = {"launches": {}}
    t0 = time.perf_counter()
    planes128, fcs128, fcp128, truth128 = sweep_stack(SWEEP_PIPE[0])
    B = SWEEP_B
    planes, fcs, fcp, truth = (planes128[:B], fcs128[:B], fcp128[:B],
                               truth128[:B])
    caps = [fc_sweep._to_complex(planes, b) for b in range(B)]
    print(f"sweep set-up: {SWEEP_PIPE[0]} carriers "
          f"{fcs128[0] / 1e6:.1f}-{fcs128[-1] / 1e6:.1f} MHz, {len(fset)} "
          f"hypotheses, uint8 planes {planes.nbytes / 1e6:.1f} MB at B = "
          f"{B} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # Batched K1 against its plain version at the sweep's inputs.
    cap = fc_sweep.device_planes(planes, dev)
    banks, bank_idx, starts, n_comb, _ = fc_sweep.scan_inputs(
        fcs, fcp, fset, 1.92e6, cap.shape[2], dev)
    got = xcorr_torch.xcorr_fold_batch(cap, banks, bank_idx, starts, n_comb)
    want = xcorr_torch.xcorr_fold_batch_plain(cap, banks, bank_idx, starts,
                                              n_comb)
    torch.cuda.synchronize()
    out["k1_batch_err"] = close(
        got, want, f"xcorr_fold batched B={B} ({banks.shape[0]} banks) "
        f"n_f={len(fset)} n_comb={n_comb}")
    # A bank index out of range gives its capture NaN and reads nothing.
    bad = torch.tensor([0, banks.shape[0]], dtype=torch.int32, device=dev)
    got2 = xcorr_torch.xcorr_fold_batch(cap[:2], banks, bad, starts[:2],
                                        n_comb)
    check(bool(torch.isnan(got2[1]).all()) and torch.equal(got2[0], got[0]),
          "xcorr_fold batched: a bank index out of range gives that "
          "capture NaN, the other capture its result")
    del got, want, got2
    # K1 batched in one launch against 64 one-capture launches, CUDA
    # events, in turns in this call.
    one = (cap[0], banks[0], starts[0], n_comb)
    t_b, t_1, t_plain = [], [], []
    for _ in range(2):
        t_b.append(cuda_ms(lambda: xcorr_torch.xcorr_fold_batch(
            cap, banks, bank_idx, starts, n_comb)))
        t_1.append(cuda_ms(lambda: xcorr_torch.xcorr_fold(*one)))
    t_plain = cuda_ms(lambda: xcorr_torch.xcorr_fold_batch_plain(
        cap, banks, bank_idx, starts, n_comb))
    n_ch = 3 * len(fset)
    w_re = banks[0, :, :, 0].reshape(n_ch, -1)
    w_im = banks[0, :, :, 1].reshape(n_ch, -1)
    weight = torch.cat([torch.stack([w_re, -w_im], 1),
                        torch.stack([w_im, w_re], 1)], 0)
    t_conv = cuda_ms(lambda: torch.nn.functional.conv1d(cap, weight))
    out["k1_batch"] = dict(
        ms=float(np.median(t_b)), single_ms=float(np.median(t_1)),
        plain_ms=t_plain, conv_ms=t_conv,
        bound_ms=B * scan_tc_flops(len(fset), n_comb) / PEAK_TF32_FLOPS
        * 1e3, runs=t_b, single_runs=t_1)
    kb = out["k1_batch"]
    print(f"K1 batched B={B}: {kb['ms']:.4f} ms (runs {t_b}) against 64 x "
          f"its one-capture {kb['single_ms']:.4f} ms = "
          f"{B * kb['single_ms']:.4f} ms (runs {t_1}); bound "
          f"{kb['bound_ms']:.4f} ms ({100 * kb['bound_ms'] / kb['ms']:.1f}%"
          f"); plain loop {t_plain:.3f} ms; F.conv1d of the stack against "
          f"one bank {t_conv:.3f} ms", flush=True)
    del cap, banks, bank_idx, starts

    # The whole-stack sweep, its launches, against the serial search.
    def whole():
        return fc_sweep.sharded_search_sweep(planes, fcs, fset,
                                             fc_prog_list=fcp)

    whole()                                    # warm: banks, constants
    torch.cuda.synchronize()
    kernels.reset_launches()
    per_cap, deduped = whole()
    torch.cuda.synchronize()
    out["launches"]["whole"] = dict(kernels.LAUNCHES)
    print(f"sweep path launches, whole stack B={B}: "
          f"{json.dumps(out['launches']['whole'])}", flush=True)
    got = sweep_cells(per_cap)
    want_ids = [[] if t is None else [t] for t in truth]
    check([[c[:3] for c in cells] for cells in got] == want_ids,
          f"whole-stack sweep B={B}: every capture gives its cell (271, "
          f"503, 90, none in turn): {sum(map(bool, got))} of {B} carriers "
          f"with cells, deduped {sorted(c.n_id_cell() for c in deduped)}")
    serial = [cell_search(caps[b], fcs[b], fcp[b], f_search_set=fset,
                          interp="freq_time") for b in range(B)]
    check(sweep_cells(serial) == got,
          "whole-stack sweep: each capture's cells equal the serial "
          "cell_search's (IDs, CP, nRB, ports, SFN, PHICH exact)")
    cpu4, _ = fc_sweep.sharded_search_sweep(planes[:4], fcs[:4], fset,
                                            device="cpu",
                                            fc_prog_list=fcp[:4])
    fs_diff = max(abs(a.freq_superfine - b.freq_superfine)
                  for x, y in zip(per_cap[:4], cpu4) for a, b in zip(x, y))
    check(sweep_cells(cpu4) == got[:4] and fs_diff < 0.5,
          f"whole-stack sweep: the card's first 4 captures equal a "
          f"device='cpu' run (freq_superfine within 0.5 Hz: "
          f"{fs_diff:.4f} Hz)")
    shared, _ = fc_sweep.sharded_search_sweep(planes, fcs, fset,
                                              fc_prog_list=fcp,
                                              share_banks=True)
    n_banks = {k[-1]: v[0][0].shape[0] for k, v in
               fc_sweep._DEV_BANK_CACHE.items() if k[0] == tuple(fcs)}
    check(sweep_cells(shared) == got,
          f"share_banks: the same cells ({n_banks.get(True)} banks shared "
          f"against {n_banks.get(False)} exact)")
    # A full first-pass table is redone on the card (max_peaks=1 fills
    # every table that holds a peak): the peaks equal the 64-slot pass's.
    def peak_rows(peaks):
        return [[(c.n_id_2, c.ind, c.freq, c.pss_pow) for c in p]
                for p in peaks]

    first64 = fc_sweep.sharded_fc_sweep(planes[:4], fcs[:4], fset,
                                        fc_prog_list=fcp[:4])
    redone = fc_sweep.sharded_fc_sweep(planes[:4], fcs[:4], fset,
                                       fc_prog_list=fcp[:4], max_peaks=1)
    check(peak_rows(redone) == peak_rows(first64)
          and sum(len(p) > 1 for p in redone) >= 3,
          f"full peak tables (max_peaks=1) redone on the card: the peaks "
          f"equal the 64-slot pass's ({[len(p) for p in redone]} peaks "
          f"per capture)")

    # The pipelined sweep at 128 x 32 against the whole stack of the same
    # 128 captures.
    def pipe(stage_s=None):
        return pipelined_search_sweep(planes128, fcs128, fset,
                                      batch=SWEEP_PIPE[1],
                                      fc_prog_list=fcp128, stage_s=stage_s)

    pipe()
    torch.cuda.synchronize()
    kernels.reset_launches()
    p_cap, _ = pipe()
    torch.cuda.synchronize()
    out["launches"]["pipelined"] = dict(kernels.LAUNCHES)
    n_chunks = -(-SWEEP_PIPE[0] // SWEEP_PIPE[1])
    print(f"sweep path launches, pipelined {SWEEP_PIPE[0]} x "
          f"{SWEEP_PIPE[1]}: {json.dumps(out['launches']['pipelined'])}",
          flush=True)
    w128, _ = fc_sweep.sharded_search_sweep(planes128, fcs128, fset,
                                            fc_prog_list=fcp128)
    fs_diff = max([abs(a.freq_superfine - b.freq_superfine)
                   for x, y in zip(p_cap, w128) for a, b in zip(x, y)]
                  or [0.0])
    bit_equal = p_cap == w128
    check(sweep_cells(p_cap) == sweep_cells(w128) and fs_diff < 0.5,
          f"pipelined {SWEEP_PIPE[0]} x {SWEEP_PIPE[1]}: each capture's "
          f"cells equal the whole stack's (freq_superfine within 0.5 Hz: "
          f"{fs_diff:.3e} Hz; every field bit-equal: {bit_equal})")
    for path, want_k1 in (("whole", 1), ("pipelined", n_chunks)):
        lc = out["launches"][path]
        check(lc["xcorr_fold"] == want_k1
              and all(lc[k] > 0 for k in SWEEP_KERNELS),
              f"sweep path ({path}): xcorr_fold launched "
              f"{lc['xcorr_fold']} time(s) (want {want_k1}: once per "
              f"chunk), fd_demod {lc['fd_demod']}, viterbi {lc['viterbi']}")

    # The CLI on the card: the batched sweep of the simulator, recorded,
    # then loaded.
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        args = [sys.executable, "-m", "lte_cell_scanner_tpu_torch.search.cli",
                "--freq-start", "739e6", "--freq-end", "745.3e6",
                "--batch-sweep", "--sweep-batch", "32", "-b", "-d", tmp]
        tables = []
        for src in (["--simulate", "-r"], ["--load"]):
            t1 = time.perf_counter()
            r = subprocess.run(args + src, cwd=HERE, capture_output=True,
                               text=True, timeout=600)
            rows = [ln for ln in r.stdout.splitlines()
                    if ln.split()[:1] and ln.split()[0].isdigit()]
            tables.append(rows)
            print(f"CLI {' '.join(src)} --batch-sweep --sweep-batch 32 "
                  f"({time.perf_counter() - t1:.1f} s): rc {r.returncode}, "
                  f"rows {rows}" + (f"\n{r.stderr[-2000:]}" if r.returncode
                                    else ""), flush=True)
        check(tables[0][:1] != [] and tables[0][0].split()[0] == "271"
              and tables[0] == tables[1],
              "the CLI (--simulate --batch-sweep --sweep-batch 32 -r, "
              "739.0-745.3 MHz, on the card) finds cell 271, and --load of "
              "its recordings prints the same table")

    # Times per carrier: the serial loop, the whole stack, the pipeline
    # (host clock ending in a device sync, median of SWEEP_REPS runs).
    sub = list(range(min(16, B)))
    t_serial = host_ms_n(lambda: [cell_search(
        caps[b], fcs[b], fcp[b], f_search_set=fset, interp="freq_time")
        for b in sub], SWEEP_REPS)
    t_whole = host_ms_n(whole, SWEEP_REPS)
    t_pipe = host_ms_n(pipe, SWEEP_REPS)
    stages = {}
    pipe(stages)
    out["ms_per_carrier"] = dict(
        serial=t_serial[0] / len(sub), whole=t_whole[0] / B,
        pipelined=t_pipe[0] / SWEEP_PIPE[0])
    print(f"sweep ms per carrier (host clock, median of {SWEEP_REPS}): "
          f"serial cell_search {out['ms_per_carrier']['serial']:.3f} "
          f"({len(sub)} carriers, runs {t_serial[1]}), whole stack B={B} "
          f"{out['ms_per_carrier']['whole']:.3f} (runs {t_whole[1]}), "
          f"pipelined {SWEEP_PIPE[0]} x {SWEEP_PIPE[1]} "
          f"{out['ms_per_carrier']['pipelined']:.3f} (runs {t_pipe[1]})")
    print("  pipeline stages (host ms per chunk, one sweep; a stage that "
          "waits for the card carries the wait): " + ", ".join(
              f"{k} {v * 1e3 / n_chunks:.3f}" for k, v in stages.items()))
    # Profiled last in the script (main): a torch.profiler run leaves
    # launch overhead behind it, which would load every later host-clock
    # timing of this process.
    out["profile"] = (whole, t_whole[0])
    # What the multi phase holds its shards to: the one-card runs.
    out["stack"] = (planes128, fcs128, fcp128)
    out["whole_cells"], out["pipe_cells"] = per_cap, p_cap
    return out


def wideband_recording() -> np.ndarray:
    """The wideband path's recording: the plants upsampled x16, each
    shifted to its carrier, summed, plus complex Gaussian noise (0.001 per
    component); the first WB_N samples."""
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.utils.dsp import interpft

    t = np.arange(WB_N)
    wide = np.zeros(WB_N, complex)
    for fc, kw, _ in WB_PLANTS:
        cap = synthetic_capture(n_subframes=90, **kw)
        up = interpft(cap, len(cap) * WB_DECIM)[:WB_N]
        wide += up * np.exp(2j * np.pi * (fc - WB_CENTER) * t / WB_FS)
    rng = np.random.default_rng(SWEEP_SEED)
    return wide + 0.001 * (rng.standard_normal(WB_N)
                           + 1j * rng.standard_normal(WB_N))


def wideband_stages(wide, fcs, fset) -> dict:
    """Host-clock seconds of each stage of one wideband sweep, each ending
    in a device sync: channelize (upload and channelizer), scan (K1 over
    the stack), peaks (the peak loop, the tables' copy and the host
    planning), sync and MIB (StackDecode's programs)."""
    import torch

    from lte_cell_scanner_tpu_torch.constants import (DS_COMB_ARM,
                                                      THRESH2_N_SIGMA)
    from lte_cell_scanner_tpu_torch.ops.peak_torch import (
        peak_search_device, r_th1_normalized)
    from lte_cell_scanner_tpu_torch.ops.xcorr_torch import xcorr_core_batch
    from lte_cell_scanner_tpu_torch.parallel import fc_sweep
    from lte_cell_scanner_tpu_torch.search.wideband import channelize_batch

    st, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st[name], t0 = t1 - t0, t1

    cap = channelize_batch(wide, WB_FS, WB_CENTER, fcs)
    lap("channelize")
    n_cap = cap.shape[2]
    banks, bank_idx, starts, n_comb, n_sp = fc_sweep.scan_inputs(
        fcs, fcs, fset, 1.92e6, n_cap, cap.device)
    packed, single = xcorr_core_batch(cap, banks, bank_idx, starts, n_comb,
                                      n_sp, DS_COMB_ARM)
    lap("scan")
    r_norm = r_th1_normalized(n_comb, DS_COMB_ARM)
    scan = fc_sweep.StackScan(
        peak_search_device(packed, single, r_norm, DS_COMB_ARM,
                           early_exit=False), packed, single, r_norm,
        DS_COMB_ARM)
    peaks = fc_sweep.tables_to_peaks(scan.host_tables(), fcs, fset)
    lap("peaks")
    del scan, packed, single
    dec = fc_sweep.StackDecode(peaks, fc_sweep.flat_stack(cap), n_cap,
                               THRESH2_N_SIGMA, "freq_time")
    dec.dispatch_sync()
    dec.collect_sync()
    lap("sync")
    dec.dispatch_mib()
    dec.collect_mib()
    lap("mib")
    return st


def wideband_path(fset, close) -> dict:
    """The wideband path on the card, with the kernels' launch counts set
    to 0 just before one sweep and read just after: the recording's 296
    carriers channelized in one call (held to the float64 decimation and
    to the per-carrier form at the first, centre, last and planted
    carriers), swept as one stack (K1 once, K4 and K5 once per CP group):
    every plant decoded as planted, the deduplicated cells exactly the
    plants, no cell more than 1 MHz from a plant; at the plants and two
    empty carriers the cells of a float64-channelized sweep and of a
    device="cpu" run; share_banks; the CLI's --wideband on an .it file and
    on raw rtl_sdr bytes. Times the sweep (ms per carrier and its stages),
    the channelizer (CUDA events, against its bound) and K1 at B = 296
    against 296 one-capture launches; returns the sweep to be profiled at
    the end of the script."""
    import tempfile

    import torch

    from lte_cell_scanner_tpu_torch import kernels
    from lte_cell_scanner_tpu_torch.io.frontend import (decimate_capture,
                                                        design_decimation_fir)
    from lte_cell_scanner_tpu_torch.io.itfile import save_it
    from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
    from lte_cell_scanner_tpu_torch.ops import xcorr_torch
    from lte_cell_scanner_tpu_torch.parallel import fc_sweep
    from lte_cell_scanner_tpu_torch.search import wideband as wb

    dev = torch.device("cuda")
    out = {}
    t0 = time.perf_counter()
    wide = wideband_recording()
    fcs = wb.wideband_carriers(WB_FS, WB_CENTER, WB_CENTER - WB_FS / 2,
                               WB_CENTER + WB_FS / 2)
    B = len(fcs)
    plant_idx = [fcs.index(fc) for fc, _, _ in WB_PLANTS]
    print(f"wideband set-up: {WB_N:,} samples at {WB_FS / 1e6:.2f} Msps "
          f"around {WB_CENTER / 1e6:.1f} MHz, {B} carriers "
          f"{fcs[0] / 1e6:.1f}-{fcs[-1] / 1e6:.1f} MHz, plants at "
          f"{[fc / 1e6 for fc, _, _ in WB_PLANTS]} MHz "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(B == 296, f"wideband: the 30.72 Msps recording's raster holds "
          f"{B} carriers (want 296)")

    # All carriers in one call, against the float64 decimation and the
    # per-carrier form at the first, centre, last and planted carriers.
    t1 = time.perf_counter()
    ch = wb.channelize_batch(wide, WB_FS, WB_CENTER, fcs)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    sample = sorted({0, B // 2, B - 1, *plant_idx})
    per = wb.channelize_batch_map(wide, WB_FS, WB_CENTER,
                                  [fcs[i] for i in sample]).cpu().numpy()
    got = ch[sample].cpu().numpy()
    err_host, err_map = [], []
    for k, i in enumerate(sample):
        host = decimate_capture(wide, WB_FS, freq_shift=fcs[i] - WB_CENTER
                                )[:ch.shape[2]]
        scale = np.abs(host).max()
        err_host.append(np.abs(got[k, 0] + 1j * got[k, 1] - host).max()
                        / scale)
        err_map.append(np.abs(got[k] - per[k]).max() / np.abs(per[k]).max())
    check(tuple(ch.shape) == (B, 2, 153600) and ch.is_contiguous()
          and max(err_host) < 2e-4,
          f"channelizer, {B} carriers in one call ({t_first:.3f} s, the "
          f"tables' build included): shape {tuple(ch.shape)}, at carriers "
          f"{sample} within {max(err_host):.3e} x max of the float64 "
          "decimation (want < 2e-4)")
    check(max(err_map) < 2e-4,
          f"channelizer: the filter bank within {max(err_map):.3e} x max of "
          "the per-carrier form at the same carriers (want < 2e-4)")
    out["channelizer_err"] = max(err_host)

    # K1 over the 296-capture stack against its plain version and against
    # 296 one-capture launches, CUDA events, in turns.
    banks, bank_idx, starts, n_comb, _ = fc_sweep.scan_inputs(
        fcs, fcs, fset, 1.92e6, ch.shape[2], dev)
    k1 = xcorr_torch.xcorr_fold_batch(ch, banks, bank_idx, starts, n_comb)
    want = xcorr_torch.xcorr_fold_batch_plain(ch, banks, bank_idx, starts,
                                              n_comb)
    torch.cuda.synchronize()
    out["k1_err"] = close(k1, want, f"xcorr_fold batched B={B} "
                          f"({banks.shape[0]} banks) n_f={len(fset)} "
                          f"n_comb={n_comb}")
    del k1, want
    t_b, t_1 = [], []
    for _ in range(2):
        t_b.append(cuda_ms(lambda: xcorr_torch.xcorr_fold_batch(
            ch, banks, bank_idx, starts, n_comb)))
        t_1.append(cuda_ms(lambda: xcorr_torch.xcorr_fold(
            ch[0], banks[0], starts[0], n_comb)))
    out["k1"] = dict(ms=float(np.median(t_b)),
                     single_ms=float(np.median(t_1)),
                     bound_ms=B * scan_tc_flops(len(fset), n_comb)
                     / PEAK_TF32_FLOPS * 1e3, runs=t_b, single_runs=t_1)
    k = out["k1"]
    print(f"K1 batched B={B}: {k['ms']:.4f} ms (runs {t_b}) against {B} x "
          f"its one-capture {k['single_ms']:.4f} ms = "
          f"{B * k['single_ms']:.4f} ms (runs {t_1}); bound "
          f"{k['bound_ms']:.4f} ms ({100 * k['bound_ms'] / k['ms']:.1f}%); "
          f"output {B * 3 * len(fset) * 9600 * 4 / 1e9:.2f} GB", flush=True)
    del banks, bank_idx, starts

    # The channelizer alone (CUDA events): the filter bank at B = 296 and
    # the per-carrier form per carrier, against the bank's bound: its
    # product's flops (2 B rows x n_out x 2 L taps, FMA = 2) and 12 flops
    # per rotated sample over the f32 rate, or each input read once and
    # each output written once.
    bank = wb.make_channelizer(WB_FS, WB_CENTER, fcs, WB_N)
    planes = wb.wide_planes(wide, bank.device)
    per16 = wb.make_channelizer_map(WB_FS, WB_CENTER, fcs[:16], WB_N)
    L, n_out = len(design_decimation_fir(WB_DECIM)), bank.n_out
    ch_b = bound(2 * 2 * B * n_out * 2 * L + 12 * B * n_out,
                 4 * (2 * bank.n_used + bank.kern.numel() + bank.t1.numel()
                      + bank.t2.numel() + 2 * B * n_out))
    out["channelizer"] = dict(bank_ms=cuda_ms(lambda: bank(planes)),
                              map_ms_per_carrier=cuda_ms(
                                  lambda: per16(planes)) / 16,
                              bound_ms=ch_b[0], bound_by=ch_b[1])
    c = out["channelizer"]
    print(f"channelizer (CUDA events, median of {REPS}): filter bank "
          f"{c['bank_ms']:.4f} ms for {B} carriers ({c['bank_ms'] / B:.5f} "
          f"ms per carrier), bound {ch_b[0]:.4f} ms by {ch_b[1]} "
          f"({100 * ch_b[0] / c['bank_ms']:.1f}%); per-carrier form "
          f"{c['map_ms_per_carrier']:.4f} ms per carrier "
          f"({c['map_ms_per_carrier'] * B / c['bank_ms']:.1f}x the bank "
          f"at {B})", flush=True)
    del ch, planes, per16

    # The sweep: its launches, its peak memory, its cells.
    def sweep(fc_list=fcs, **kw):
        return wb.wideband_search_sweep(wide, WB_FS, WB_CENTER, fc_list,
                                        fset, **kw)

    sweep()                                     # warm: banks, tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    per_cap, deduped = sweep()
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    out["max_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    lc = out["launches"]
    print(f"wideband path launches, B={B}: {json.dumps(lc)}; max memory "
          f"allocated {out['max_mem_gb']:.3f} GB", flush=True)
    check(lc["xcorr_fold"] == 1 and lc["fd_demod"] == 2
          and lc["viterbi"] == 2,
          f"wideband path: xcorr_fold launched {lc['xcorr_fold']} time(s), "
          f"fd_demod {lc['fd_demod']}, viterbi {lc['viterbi']} (want 1, 2, "
          "2: one scan of the stack, one MIB program per CP type)")
    got = sweep_cells(per_cap)
    for (fc, kw, want_cell), i in zip(WB_PLANTS, plant_idx):
        df = [abs(c.freq_superfine - kw["freq_offset"]) for c in per_cap[i]]
        check(got[i] == [want_cell] and df[0] < 50,
              f"wideband {fc / 1e6:.1f} MHz: decodes {got[i]} (want "
              f"{[want_cell]}), freq_superfine {df} Hz from the planted "
              "offset (want < 50)")
    plants = sorted(w[0] for _, _, w in WB_PLANTS)
    check(sorted(c.n_id_cell() for c in deduped) == plants,
          f"wideband: deduped {sorted(c.n_id_cell() for c in deduped)} is "
          f"exactly the plants {plants}")
    far = [b for b in range(B)
           if min(abs(fcs[b] - fc) for fc, _, _ in WB_PLANTS) > 1e6]
    false = {fcs[b] / 1e6: got[b] for b in far if got[b]}
    check(not false, f"wideband: no cell on the {len(far)} carriers more "
          f"than 1 MHz from a plant (found {false})")
    print(f"wideband: cells on {sum(map(bool, got))} of {B} carriers: "
          + ", ".join(f"{fcs[b] / 1e6:.1f} {[x[0] for x in got[b]]}"
                      for b in range(B) if got[b]), flush=True)
    # The plants and two empty carriers: the float64 route and the CPU.
    sub = plant_idx + [fcs.index(fc) for fc in WB_EMPTY]
    sub_fcs = [fcs[i] for i in sub]
    ref = [got[i] for i in sub]
    for what, kw in (("the float64-channelized sweep (backend='numpy')",
                      dict(backend="numpy")),
                     ("a device='cpu' run", dict(device="cpu"))):
        t1 = time.perf_counter()
        other, _ = sweep(sub_fcs, **kw)
        df = max([abs(a.freq_superfine - b.freq_superfine) for i, o in
                  zip(sub, other) for a, b in zip(per_cap[i], o)] or [0.0])
        check(sweep_cells(other) == ref and df < 1.0,
              f"wideband at the plants and {len(WB_EMPTY)} empty carriers: "
              f"the card's cells equal {what} ({time.perf_counter() - t1:.1f}"
              f" s; freq_superfine within {df:.4f} Hz, want < 1)")
    shared, _ = sweep(share_banks=True)
    check(sweep_cells(shared) == got, "wideband share_banks: the same cells")

    # The CLI on the card: the recording as an .it file (its fs field the
    # default --fs-in) and as raw rtl_sdr bytes.
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    lo, hi = min(fc for fc, _, _ in WB_PLANTS), max(fc for fc, _, _ in
                                                    WB_PLANTS)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        it_path = os.path.join(tmp, "wide.it")
        raw_path = os.path.join(tmp, "wide.raw")
        save_it(it_path, {"capbuf": wide, "fc": np.array([WB_CENTER]),
                          "fs": np.array([WB_FS])})
        iq_to_bytes(wide / (4 * np.abs(wide).std())).tofile(raw_path)
        base = [sys.executable, "-m", "lte_cell_scanner_tpu_torch.search.cli",
                "-s", f"{lo:.0f}", "-e", f"{hi:.0f}", "-p", "100"]
        for name, args in (
                ("--wideband FILE.it", ["--wideband", it_path]),
                ("--wideband FILE.raw --wideband-rtl-sdr",
                 ["--wideband", raw_path, "--wideband-rtl-sdr", "--fs-in",
                  f"{WB_FS:.0f}", "--fc-center", f"{WB_CENTER:.0f}"])):
            t1 = time.perf_counter()
            r = subprocess.run(base + args, cwd=HERE, capture_output=True,
                               text=True, timeout=600)
            lines = r.stdout.splitlines()
            head = [i for i, ln in enumerate(lines) if ln.startswith("CID ")]
            rows = lines[head[0] + 1:] if head else []
            ids = sorted(int(ln.split()[0]) for ln in rows if ln.strip())
            print(f"CLI {name} ({time.perf_counter() - t1:.1f} s): rc "
                  f"{r.returncode}, rows {rows}" + (
                      f"\n{r.stderr[-2000:]}" if r.returncode else ""),
                  flush=True)
            check(r.returncode == 0 and ids == plants,
                  f"the CLI ({name}, {lo / 1e6:.1f}-{hi / 1e6:.1f} MHz, on "
                  f"the card) prints the plants {plants}: {ids}")

    # Times: the sweep per carrier (host clock, median of SWEEP_REPS warm
    # sweeps) and its stages.
    t_sweep = host_ms_n(sweep, SWEEP_REPS)
    stages = [wideband_stages(wide, fcs, fset) for _ in range(SWEEP_REPS)]
    out["ms_per_carrier"] = t_sweep[0] / B
    out["stages_ms_per_carrier"] = {
        k: float(np.median([s[k] for s in stages])) * 1e3 / B
        for k in stages[0]}
    print(f"wideband sweep, {B} carriers: {out['ms_per_carrier']:.4f} ms per "
          f"carrier (host clock, median of {SWEEP_REPS}: runs {t_sweep[1]} "
          "ms); stages, ms per carrier (each ending in a sync): " + ", ".join(
              f"{k} {v:.4f}" for k, v in out["stages_ms_per_carrier"].items()),
          flush=True)
    out["profile"] = (sweep, t_sweep[0])
    out["wide"], out["fcs"], out["cells"] = wide, fcs, per_cap
    return out


def turns(fns: dict, n: int) -> dict:
    """(median, runs) of host wall milliseconds (each run ending in a
    device sync) of each of ``fns``, one warm-up each, then ``n`` rounds
    taking them in turns."""
    import torch

    for fn in fns.values():
        fn()
    runs = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs[k].append(round((time.perf_counter() - t0) * 1e3, 3))
    return {k: (float(np.median(v)), v) for k, v in runs.items()}


def tracker_split(drive, n_cards: int) -> dict:
    """The tracker's cell axis: one real engine cycle at the capacity run's
    full width (CAP_CELLS cells x CHUNK_MS) with its demod and stats
    programs split over two shards on cuda:0 and over every visible card
    (``check_tracker_cells_sharded``, driven through ``drive``), then each
    program timed unsplit and over two shards on cuda:0. Returns the
    times, {program and layout: [ms, ms]}."""
    from lte_cell_scanner_tpu_torch.parallel.multichip_checks import (
        check_tracker_cells_sharded, run_tracker_shards, split_tracker_cycle,
        tracker_cycle)
    from lte_cell_scanner_tpu_torch.tracker import batch_runtime as br

    for what, kw in (("2 shards on cuda:0",
                      dict(n_devices=2, devices=["cuda:0"] * 2)),
                     (f"every visible card ({n_cards})",
                      dict(n_devices=n_cards))):
        what = f"tracker cycle {CAP_CELLS} cells x {CHUNK_MS:.0f} ms, {what}"
        t1 = time.perf_counter()
        try:
            res, _ = drive(what, lambda: check_tracker_cells_sharded(
                cells=CAP_CELLS, cycle_ms=CHUNK_MS, verbose=True, **kw))
        except AssertionError as e:
            check(False, f"{what}: {e}")
            continue
        k4 = res["launches"]["fd_demod_stream"]
        worst = {f: v for f, v in res["fields"].items() if v[0] != v[1]}
        check(k4 == kw["n_devices"],
              f"{what} ({time.perf_counter() - t1:.1f} s): shards "
              f"{res['shards']}, {res['triples']} triples; demod, CE rows, "
              f"ac_td history and FOE/TOE bit-equal to one device's, the "
              f"diagnostic lanes within the JAX bound (not bit-equal: "
              f"{worst or 'none'}); fd_demod_stream launched {k4} time(s) "
              f"in the split run (want {kw['n_devices']}: once per shard)")
    # The split against the unsplit cycle on cuda:0, each program timed
    # with CUDA events (median of REPS), twice in turns.
    da, sa = tracker_cycle(CAP_CELLS, "cuda:0", CHUNK_MS)
    shards = split_tracker_cycle(da, sa, ["cuda:0"] * 2)
    ce1 = br._demod_stream(*da)[1]
    outs = run_tracker_shards(shards)
    fns = {
        "demod, 1 device": lambda: br._demod_stream(*da),
        "demod, 2 shards": lambda: [br._demod_stream(*sh["demod"])
                                    for sh in shards],
        "stats, 1 device": lambda: br._stats(ce1, *sa[1:]),
        "stats, 2 shards": lambda: [br._stats(o[1], *sh["stats"],
                                              sh["n_seg"])
                                    for sh, o in zip(shards, outs)]}
    split = {}
    for _ in range(2):
        for k, fn in fns.items():
            split.setdefault(k, []).append(cuda_ms(fn))
    print(f"multi: tracker cycle {CAP_CELLS} cells x {CHUNK_MS:.0f} ms "
          f"({da[1].numel()} windows, {sa[2].shape[0]} triples) on cuda:0, "
          f"ms (CUDA events, median of {REPS}, twice in turns): " + ", ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in split.items())
          + f"; {card_line()}", flush=True)
    return split


def multi_path(sweep: dict, wband: dict, fset) -> dict:
    """The multi-device paths on the card, with the kernels' launch counts
    set to 0 just before each drive and read just after (summed into the
    phase's launches): the 64-carrier whole stack over every visible card
    (:func:`all_cards_mesh`) and over two shards on cuda:0, the 128 x 32
    pipeline and the 296-carrier wideband sweep over two shards on
    cuda:0, each shard launching K1 once (once per chunk in the
    pipeline) and every decoded cell equal to the one-shard run's (the
    sweep and wideband phases); dryrun_multichip on ("cuda:0",) x 4 at
    (seq 2, hyp 2), its float32 tables within SCAN_RTOL x max of the
    unsharded K1 scan; a world-size-1 NCCL process group and one
    sharded_xcorr_pss through the collective path, against the same
    mesh in one process; the tracker cycle's cell axis
    (:func:`tracker_split`). Times the whole stack at 1 and 2 shards (ms
    per carrier), K1 at B = 32 against B = 64 in one launch, and the (seq,
    hyp) scan at (1,1), (2,1), (1,2), (2,2) shards against the unsharded
    scan (host clock, in turns)."""
    import socket

    import torch
    import torch.distributed as dist

    from lte_cell_scanner_tpu_torch import kernels
    from lte_cell_scanner_tpu_torch.ops import xcorr_torch
    from lte_cell_scanner_tpu_torch.parallel import fc_sweep
    from lte_cell_scanner_tpu_torch.parallel.multichip_checks import (
        SCAN_RTOL, dryrun_multichip, k1_scan, planted_capture, same_cells,
        scan_close)
    from lte_cell_scanner_tpu_torch.parallel.multihost import init_multihost
    from lte_cell_scanner_tpu_torch.parallel.sharded_search import (
        make_search_mesh, sharded_xcorr_pss)
    from lte_cell_scanner_tpu_torch.search import wideband as wb
    from lte_cell_scanner_tpu_torch.search.pipeline import \
        pipelined_search_sweep

    n_cards = torch.cuda.device_count()
    print(f"multi: torch.cuda.device_count() = {n_cards} "
          f"({card_line()})", flush=True)
    out = {"launches": dict.fromkeys(kernels.KERNELS, 0)}

    def drive(what, fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        lc = dict(kernels.LAUNCHES)
        for k in lc:
            out["launches"][k] += lc[k]
        print(f"multi path launches, {what}: {json.dumps(lc)}", flush=True)
        return r, lc

    def cells_equal(got, want, what):
        try:
            bit = same_cells(got, want)
        except AssertionError as e:
            check(False, f"{what}: cells differ from one shard's ({e})")
            return
        check(True, f"{what}: every decoded cell equals the one-shard "
              f"run's (IDs, CP, nRB, ports, SFN, PHICH exact, "
              f"freq_superfine within 0.5 Hz; every field bit-equal: {bit})")

    planes128, fcs128, fcp128 = sweep["stack"]
    B = SWEEP_B
    planes, fcs, fcp = planes128[:B], fcs128[:B], fcp128[:B]
    every = fc_sweep.all_cards_mesh(B)
    two = fc_sweep.CapMesh(["cuda:0", "cuda:0"])

    def whole(mesh):
        return lambda: fc_sweep.sharded_search_sweep(planes, fcs, fset, mesh,
                                                     fc_prog_list=fcp)[0]

    for what, mesh in ((f"whole stack B={B} over every card", every),
                       (f"whole stack B={B}, 2 shards on cuda:0", two)):
        whole(mesh)()                       # warm: the mesh's banks
        got, lc = drive(what, whole(mesh))
        n_sh = len(mesh.devices)
        cells_equal(got, sweep["whole_cells"], what)
        check(lc["xcorr_fold"] == n_sh and lc["fd_demod"] == 2 * n_sh
              and lc["viterbi"] == 2 * n_sh,
              f"{what}: xcorr_fold launched {lc['xcorr_fold']} time(s), "
              f"fd_demod {lc['fd_demod']}, viterbi {lc['viterbi']} (want "
              f"{n_sh}, {2 * n_sh}, {2 * n_sh}: once per shard, one MIB "
              "program per CP type per shard)")
    t = turns({"1 shard": whole(fc_sweep.CapMesh(["cuda:0"])),
               "2 shards": whole(two)}, SWEEP_REPS)
    out["whole_ms_per_carrier"] = {k: v[0] / B for k, v in t.items()}
    out["profile"] = (whole(two), t["2 shards"][0])
    print(f"multi: whole stack B={B} on cuda:0, ms per carrier (host "
          f"clock, median of {SWEEP_REPS} in turns): " + ", ".join(
              f"{k} {v[0] / B:.4f} (runs {v[1]} ms)" for k, v in t.items())
          + f"; {card_line()}", flush=True)

    # K1 at B = 32 (one shard's launch) against B = 64 in one launch.
    dev = torch.device("cuda:0")
    cap = fc_sweep.device_planes(planes, dev)
    banks, bank_idx, starts, n_comb, _ = fc_sweep.scan_inputs(
        fcs, fcp, fset, 1.92e6, cap.shape[2], dev)
    half = B // 2
    k1 = {}
    for _ in range(2):
        for n in (B, half):
            k1.setdefault(n, []).append(cuda_ms(
                lambda: xcorr_torch.xcorr_fold_batch(
                    cap[:n], banks, bank_idx[:n], starts[:n], n_comb)))
    out["k1_shard"] = {n: float(np.median(v)) for n, v in k1.items()}
    print(f"multi: K1 (CUDA events, median of {REPS}, twice in turns): "
          f"B={half} (one of two shards) {k1[half]} ms, B={B} in one launch "
          f"{k1[B]} ms; two shards on one card {2 * out['k1_shard'][half]:.4f}"
          f" ms against {out['k1_shard'][B]:.4f}; {card_line()}", flush=True)
    del cap, banks, bank_idx, starts

    # The pipeline at 128 x 32 over two shards on cuda:0.
    n_chunks = -(-SWEEP_PIPE[0] // SWEEP_PIPE[1])

    def pipe():
        return pipelined_search_sweep(planes128, fcs128, fset, two,
                                      batch=SWEEP_PIPE[1],
                                      fc_prog_list=fcp128)[0]

    pipe()
    what = f"pipelined {SWEEP_PIPE[0]} x {SWEEP_PIPE[1]}, 2 shards on cuda:0"
    got, lc = drive(what, pipe)
    cells_equal(got, sweep["pipe_cells"], what)
    check(lc["xcorr_fold"] == 2 * n_chunks,
          f"{what}: xcorr_fold launched {lc['xcorr_fold']} time(s) (want "
          f"{2 * n_chunks}: once per shard per chunk)")

    # The wideband sweep of 296 carriers over two shards on cuda:0, each
    # channelizing its own 148 carriers.
    def wide2():
        return wb.wideband_search_sweep(wband["wide"], WB_FS, WB_CENTER,
                                        wband["fcs"], fset, two)[0]

    wide2()
    what = f"wideband B={len(wband['fcs'])}, 2 shards on cuda:0"
    t1 = time.perf_counter()
    got, lc = drive(what, wide2)
    cells_equal(got, wband["cells"], what)
    check(lc["xcorr_fold"] == 2,
          f"{what} ({time.perf_counter() - t1:.3f} s): xcorr_fold launched "
          f"{lc['xcorr_fold']} time(s) (want 2: once per shard)")

    # The sharded scan's checks at production shape on one card (counts
    # not taken: a check against the unsharded scan).
    t1 = time.perf_counter()
    try:
        dry = dryrun_multichip(4, devices=["cuda:0"] * 4)
        check(True, f"dryrun_multichip on cuda:0 x 4 (seq 2 x hyp 2, "
              f"153600 x {dry['n_f']}; {time.perf_counter() - t1:.1f} s): "
              f"float32 tables within {dry['scan_err']:.3e} x max of the "
              f"unsharded K1 scan (want <= {SCAN_RTOL:g}), frq equal but at "
              "near ties; the cap-axis sweep and the pipelined check "
              f"({dry['pipelined']['cells']} cells, bit-equal "
              f"{dry['pipelined']['bit_equal']}) equal one shard's; the "
              f"tracker cycle ({dry['tracker']['cells']} cells in shards of "
              f"{dry['tracker']['shards']}) equals one device's (bit-equal: "
              f"{dry['tracker']['bit_equal']})")
    except AssertionError as e:
        check(False, f"dryrun_multichip on cuda:0 x 4: {e}")

    out["split_ms"] = tracker_split(drive, n_cards)

    # The (seq, hyp) scan: each layout on cuda:0 against the unsharded
    # K1 scan, in turns (host clock: planning, uploads, the scan and the
    # tables' copy to the host).
    cap_p, fset_p, fc_p = planted_capture(153600, len(fset) + 1)
    layouts = ((1, 1), (2, 1), (1, 2), (2, 2))
    meshes = {f"{a},{b}": make_search_mesh(a, b, devices=["cuda:0"] * (a * b))
              for a, b in layouts}

    def scan(m):
        return lambda: sharded_xcorr_pss(cap_p, fset_p, 2, fc_p, fc_p,
                                         1.92e6, m)

    fns = {"unsharded": lambda: k1_scan(cap_p, fset_p, 2, fc_p, fc_p,
                                        1.92e6, dev)}
    fns.update({k: scan(m) for k, m in meshes.items()})
    t = turns(fns, SWEEP_REPS)
    out["scan_ms"] = {k: v[0] for k, v in t.items()}
    print(f"multi: (seq, hyp) scan of 153600 x {len(fset_p)} on cuda:0, ms "
          f"(host clock, median of {SWEEP_REPS} in turns): " + ", ".join(
              f"{k} {v[0]:.3f} (runs {v[1]})" for k, v in t.items())
          + f"; {card_line()}", flush=True)
    ref = k1_scan(cap_p, fset_p, 2, fc_p, fc_p, 1.92e6, dev)
    local, lc = drive("(seq 2, hyp 2) scan, one process",
                      scan(meshes["2,2"]))
    check(lc["xcorr_fold"] == 4, f"(seq 2, hyp 2) scan: xcorr_fold "
          f"launched {lc['xcorr_fold']} time(s) (want 4: once per shard)")

    # A world-size-1 NCCL process group: the collective path.
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    try:
        init_multihost(f"127.0.0.1:{port}", 1, 0)
        try:
            mesh = make_search_mesh(2, 2, devices=["cuda:0"] * 4)
            got, lc = drive(f"(seq 2, hyp 2) scan, {dist.get_backend()} "
                            "world size 1", scan(mesh))
        finally:
            dist.destroy_process_group()
        err = scan_close(got, ref)
    except (RuntimeError, AssertionError) as e:
        check(False, f"NCCL world size 1, (seq 2, hyp 2) scan: {e}")
        return out
    bit = all(np.array_equal(getattr(got, f), getattr(local, f)) for f in (
        "xc_incoherent_single", "xc_incoherent_collapsed_frq",
        "sp_incoherent"))
    check(lc["xcorr_fold"] == 4 and err <= SCAN_RTOL,
          f"NCCL world size 1, (seq 2, hyp 2) scan through all_reduce and "
          f"all_gather: xcorr_fold launched {lc['xcorr_fold']} time(s) "
          f"(want 4), tables within {err:.3e} x max of the unsharded K1 "
          f"scan (want <= {SCAN_RTOL:g}); bit-equal to the one-process "
          f"combine: {bit}")
    return out


def playback_path() -> dict:
    """LTE-Tracker as its users run it: the tracker's simulated cell
    written to build/chip_smoke as an .it file and as raw rtl_sdr bytes,
    each played through the CLI in a subprocess (``--load FILE
    [--rtl-sdr-format] --no-repeat --noise-power P --blocks 400``), which
    must acquire cell 271 and print its status rows; then the same CLI in
    this process with ``--feeder native --expert --g2 1.5``, with the
    kernels' launch counts set to 0 just before and read just after."""
    import contextlib
    import io

    import torch

    from lte_cell_scanner_tpu_torch import kernels
    from lte_cell_scanner_tpu_torch.io.itfile import save_it
    from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.tracker import cli

    d = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    sig = synthetic_capture(n_subframes=PLAY_SUBFRAMES, **TRACKER_SIG)
    files = {"it": os.path.join(d, "track.it"),
             "raw": os.path.join(d, "track.raw")}
    save_it(files["it"], {"capbuf": sig})
    iq_to_bytes(sig).tofile(files["raw"])
    base = ["-f", "739e6", "--no-repeat", "--noise-power", str(PLAY_NOISE),
            "--blocks", str(PLAY_BLOCKS)]

    def acquired(text, what, secs):
        rows = [ln for ln in text.splitlines() if ln.split()[:1] == ["271"]]
        print("\n".join(text.splitlines()[-4:]))
        check("[cell_acquired] {'n_id_cell': 271" in text and len(rows) == 2
              and all("100.0%" in r for r in rows),
              f"tracker CLI {what} ({secs:.1f} s): acquires cell 271 and "
              f"prints its status row in {len(rows)} of 2 frames at 100% "
              "health")
        return text

    out = {}
    for what, extra in (("it", []), ("raw", ["--rtl-sdr-format"])):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "lte_cell_scanner_tpu_torch.tracker.cli",
             "--load", files[what], *extra, *base],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if r.returncode != 0:
            print(r.stderr[-2000:])
        check(r.returncode == 0, f"tracker CLI --load {what}: exit code "
              f"{r.returncode}")
        acquired(r.stdout, f"--load {files[what]} {' '.join(extra + base)}",
                 secs)
        out[f"{what}_s"] = secs
    argv = ["--load", files["it"], *base, "--feeder", "native", "--expert",
            "--g2", "1.5"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    out["native_s"] = time.perf_counter() - t0
    text = acquired(buf.getvalue(), " ".join(argv), out["native_s"])
    check(rc == 0 and "debug: g2=1.5" in text.splitlines(),
          "tracker CLI --feeder native --expert --g2 1.5 (in process): "
          "exit code 0 and the expert status prints 'debug: g2=1.5'")
    print(f"playback path launches: {json.dumps(out['launches'])}",
          flush=True)
    for name in PLAYBACK_KERNELS:
        check(out["launches"][name] > 0, f"{name} launched "
              f"{out['launches'][name]} time(s) on the CLI playback path")
    return out


def feeder_ms(n_cells: int) -> dict:
    """Host milliseconds per 10,000-sample block of each sample feeder
    over n_cells cells of distinct IDs (median of FEEDER_BLOCKS after
    FEEDER_WARM), as the tracker's step pays them: the Python feeder with
    the uint8-to-complex conversion, the C++ feeder on the raw bytes."""
    from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq, iq_to_bytes
    from lte_cell_scanner_tpu_torch.tracker.native_feeder import (
        NativeSampleFeeder)
    from lte_cell_scanner_tpu_torch.tracker.producer import SampleFeeder
    from lte_cell_scanner_tpu_torch.tracker.state import (GlobalState,
                                                          TrackedCell)

    n_blk = FEEDER_BLOCKS + FEEDER_WARM
    rng = np.random.default_rng(0)
    raw = iq_to_bytes((rng.standard_normal(n_blk * 10000)
                       + 1j * rng.standard_normal(n_blk * 10000)) * 0.2)
    feed = {"python": lambda f, b, cells: f.feed(bytes_to_iq(b), cells),
            "native": lambda f, b, cells: f.feed_bytes(b, cells)}
    out = {}
    for name, cls in (("python", SampleFeeder),
                      ("native", NativeSampleFeeder)):
        f = cls(GlobalState(FC, FC, 1.92e6, 4000.0))
        cells = [TrackedCell(n_id_cell=5 * i, n_ports=1, cp_type="normal",
                             n_rb_dl=50, phich_duration="normal",
                             phich_resource=1.0,
                             frame_timing=(i * 197.3) % 19200)
                 for i in range(n_cells)]
        times = []
        for k in range(n_blk):
            b = raw[2 * k * 10000:2 * (k + 1) * 10000]
            t0 = time.perf_counter()
            feed[name](f, b, cells)
            times.append((time.perf_counter() - t0) * 1e3)
            n_pdu = sum(len(c.fifo) for c in cells)
            for c in cells:
                c.fifo.clear()
        out[name] = float(np.median(times[FEEDER_WARM:]))
    out["pdus_per_block"] = n_pdu
    return out


def tap_errors(got, want, np_rtol=HOST_NP_RTOL) -> tuple:
    """(the same (n_id, slot, sym) sequence of more than 20 taps, {name:
    (max abs err, max |want|, within tolerance)}) of two runs' CE taps: CE
    and SP within one float16 step (rtol CE_RTOL + CE_RTOL x max), NP
    within rtol ``np_rtol`` + CE_RTOL x max (HOST_NP_RTOL between the
    engine's two PDU modes, tests/test_torch_host_tracker.py)."""
    same = [t[:3] for t in got] == [t[:3] for t in want] and len(got) > 20
    errs = {}
    if same:
        for i, name, rtol in ((3, "CE", CE_RTOL), (4, "SP", CE_RTOL),
                              (5, "NP", np_rtol)):
            g = np.stack([t[i] for t in got])
            w = np.stack([t[i] for t in want])
            errs[name] = (float(np.abs(g - w).max()), float(np.abs(w).max()),
                          bool((np.abs(g - w) <= rtol * np.abs(w)
                                + CE_RTOL * np.abs(w).max()).all()))
    return same, errs


def native_path(sig) -> dict:
    """The sample feeders and the CE tap on the card: trackers with the
    Python and the C++ feeder, each with the CE tap, on TAP_BLOCKS blocks
    of the tracker's simulated cell (the native run with the launch
    counts set to 0 just before and read just after): the same cells and
    MIB decodes; in the native run a Python feeder fed the same blocks
    and cell states must cut the same windows (start, slot, sym; late
    within 1e-6); the Python run's CE taps against a CPU run's (the same
    symbols, values within one float16 step); then the feeders' host ms
    per block at 1 and 96 cells."""
    import torch

    from lte_cell_scanner_tpu_torch import kernels
    from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq
    from lte_cell_scanner_tpu_torch.tracker.producer import SampleFeeder
    from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                            playback_source)

    shadow = {"n": 0, "bad": 0, "late": 0.0}

    def tee(trk):
        """Feed a Python feeder the native feeder's blocks and cell
        states (copies of the cells, frame timing refreshed each block)
        and compare the windows the two cut from each block."""
        py_feed, native_feed, copies = (SampleFeeder(trk.state),
                                        trk.feeder.feed_bytes, {})

        def feed_bytes(raw, cells):
            mine = []
            for c in cells:
                k = (c.n_id_cell, c.serial_num)
                if k not in copies:
                    copies[k] = dataclasses.replace(c, fifo=type(c.fifo)())
                copies[k].frame_timing, copies[k].kill_me = (c.frame_timing,
                                                            c.kill_me)
                mine.append(copies[k])
            before = [len(c.fifo) for c in cells]
            py_feed.feed(bytes_to_iq(raw), mine)
            native_feed(raw, cells)
            for c, m, n0 in zip(cells, mine, before):
                got, want = list(c.fifo)[n0:], list(m.fifo)
                m.fifo.clear()
                shadow["n"] += len(got)
                shadow["bad"] += len(got) != len(want) or any(
                    (a.start, a.slot_num, a.sym_num)
                    != (b.start, b.slot_num, b.sym_num)
                    for a, b in zip(got, want))
                shadow["late"] = max([shadow["late"]] + [
                    abs(a.late - b.late) for a, b in zip(got, want)])

        trk.feeder.feed_bytes = feed_bytes

    def run(feeder, device=None):
        taps = []
        trk = LTETracker(FC, initial_freq_offset=4000.0, feeder=feeder,
                         ce_observer=(tapped, lambda *a: taps.append(a)),
                         device=device)
        if feeder == "native":
            tee(trk)
        t0 = time.perf_counter()
        trk.run(playback_source(sig), max_blocks=TAP_BLOCKS)
        torch.cuda.synchronize()
        return trk.status(), taps, time.perf_counter() - t0

    out = {}
    py = run("python")
    torch.cuda.synchronize()
    kernels.reset_launches()
    na = run("native")
    out["launches"] = lc = dict(kernels.LAUNCHES)
    print(f"native feeder path launches: {json.dumps(lc)} ({na[2]:.1f} s "
          f"for {TAP_BLOCKS} blocks with the Python feeder beside; the "
          f"Python feeder alone {py[2]:.1f} s)", flush=True)
    for name in TRACKER_KERNELS:
        check(lc[name] > 0, f"{name} launched {lc[name]} time(s) on the "
              "native feeder path")
    cells = [[(c["n_id_cell"], c["mib_successes"], c["health"])
              for c in r[0]["cells"]] for r in (py, na)]
    check(cells[0] == cells[1] and [c[0] for c in cells[1]] == [271],
          f"native feeder on the card: cells (id, MIB decodes, health) "
          f"{cells[1]} equal the Python feeder's run's {cells[0]}; FO "
          f"{na[0]['frequency_offset']:.4f} / "
          f"{py[0]['frequency_offset']:.4f} Hz")
    check(shadow["n"] > 1000 and not shadow["bad"]
          and shadow["late"] <= 1e-6,
          f"native feeder's {shadow['n']} descriptors against a Python "
          f"feeder's on the same blocks and cell states: (start, slot, sym) "
          f"differ in {shadow['bad']} block(s), late within "
          f"{shadow['late']:.3e} (want <= 1e-6)")
    out["late"] = shadow["late"]

    cpu = run("python", "cpu")
    seq_ok, errs = tap_errors(py[1], cpu[1], np_rtol=CE_RTOL)
    check(seq_ok and all(e[2] for e in errs.values()),
          f"CE tap on the card against the CPU run: {len(py[1])} / "
          f"{len(cpu[1])} taps, (n_id, slot, sym) equal: {seq_ok}; max abs "
          f"err (of max) " + ", ".join(f"{k} {e[0]:.3e} ({e[1]:.3e})"
                                       for k, e in errs.items())
          + f" (tolerance rtol {CE_RTOL:g} + {CE_RTOL:g} x max); FO card "
          f"{py[0]['frequency_offset']:.4f}, CPU "
          f"{cpu[0]['frequency_offset']:.4f} Hz")
    out["ce_err"] = errs
    out["py"] = py
    for n in (1, CAP_CELLS):
        t = feeder_ms(n)
        out[f"feeder_ms_{n}"] = t
        print(f"feeder host ms per 10,000-sample block at {n} cell(s) "
              f"({t['pdus_per_block']} descriptors; median of "
              f"{FEEDER_BLOCKS}): python {t['python']:.3f}, native "
              f"{t['native']:.3f} ({t['python'] / t['native']:.1f}x); "
              f"{card_line()}", flush=True)
    return out


def host_path(caps, fset, found, sig, desc_run, e2e_ms, trk_s,
              device="cuda") -> dict:
    """The float64 host path and the engine's sample-carrying mode, with the
    kernels' launch counts set to 0 just before the drive and read just
    after (the comparisons with the plain versions and the timings come
    after the read):

    - cell_search(backend="numpy") on both captures with the 31-hypothesis
      grid, in hex and in 2stage: the card's cells and MIB fields,
      freq_superfine within 0.5 Hz;
    - extract_tfg_batch on the card over HOST_TFG_B replicas of each
      capture's synced candidate (K4's MIB mode once per CP group): the
      full 854/732-row grid against the float64 host extract_tfg per cell
      (timestamps within 1e-9, the grid within 2e-3 x max);
    - LTETracker(batch=False, backend="torch") on 400 blocks of the
      tracker's cell: the searcher launches K1, K4 and K5; cell 271 at
      health 1.0 with more than 10 MIB decodes; the same events, FO and
      frame timing as a device="cpu" run and as backend="numpy";
    - the engine fed sample-carrying PDUs by the Python and then the C++
      feeder over TAP_BLOCKS blocks: K4's stream mode launched, the same
      cells as the descriptor-mode run ``desc_run`` (native_path's) and
      its CE taps within one float16 step.
    Then K4 at both new shapes against its plain version, and the times:
    the float64 chain per capture (host clock, median of HOST_REPS)
    against the card's ``e2e_ms``, extract_tfg_batch at B = HOST_TFG_B
    (host clock) and its K4 launch (CUDA events) against the byte bound,
    and the host tracker's ms per block against the engine's (``trk_s``
    for 400 blocks, phase 3). ``device`` is the card's."""
    import torch

    from lte_cell_scanner_tpu_torch import kernels
    from lte_cell_scanner_tpu_torch.ops import mib_torch
    from lte_cell_scanner_tpu_torch.ops.fd_demod import (
        fd_demod, fd_demod_plain, fd_demod_stream, fd_demod_stream_plain)
    from lte_cell_scanner_tpu_torch.ops.peak_torch import (
        peak_search_device, peaks_to_cells, r_th1_normalized)
    from lte_cell_scanner_tpu_torch.ops.sync_torch import sss_foe_batch
    from lte_cell_scanner_tpu_torch.ops.tfg import extract_tfg
    from lte_cell_scanner_tpu_torch.ops.xcorr_torch import (scan_plan,
                                                            xcorr_core)
    from lte_cell_scanner_tpu_torch.search.cell_search import (cell_search,
                                                               dedup)
    from lte_cell_scanner_tpu_torch.tracker import batch_runtime as br
    from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                            playback_source)

    dev = torch.device(device)
    out, counts = {}, {}
    cap_dev = {cp: torch.from_numpy(np.stack(
        [c.real, c.imag], -1).astype(np.float32)).to(dev)
        for cp, c in caps.items()}
    # The synced candidates (their SSS/FOE on the card, before the count
    # starts), HOST_TFG_B replicas each at slightly other timings and
    # frequencies.
    groups = {}
    for cp, c in caps.items():
        plan = scan_plan(len(c), fset, FC, FC, 1.92e6)
        packed, single, _ = xcorr_core(cap_dev[cp].T.contiguous(), plan, 2)
        peaks = peaks_to_cells(peak_search_device(
            packed, single, r_th1_normalized(plan.n_comb_xc, 2),
            2).cpu().numpy(), fset, FC, FC)
        synced = [x for x in sss_foe_batch(peaks, cap_dev[cp], 3.0)
                  if x.n_id_1 >= 0 and x.cp_type == cp]
        check(bool(synced), f"host path: the {cp} CP capture yields a "
              "synced candidate")
        groups[cp] = [dataclasses.replace(
            synced[0], frame_start=synced[0].frame_start + 0.37 * i,
            freq_fine=synced[0].freq_fine + 3.0 * i)
            for i in range(HOST_TFG_B)]
    sizes, orig_fd = [], br.fd_demod_stream

    def size_tap(*args):
        sizes.append(args)
        return orig_fd(*args)

    def drive(trk, blocks):
        t0 = time.perf_counter()
        trk.run(playback_source(sig), max_blocks=blocks)
        torch.cuda.synchronize()
        st = trk.status()
        st.pop("searcher_cycle_time")
        return st, time.perf_counter() - t0

    def events_of(backend, device, batch=False, feeder="python",
                  descriptors=True):
        ev, taps = [], []
        trk = LTETracker(FC, initial_freq_offset=4000.0, backend=backend,
                         batch=batch, feeder=feeder, device=device,
                         on_event=lambda k, i: ev.append((k, i)),
                         ce_observer=(tapped, lambda *a: taps.append(a)))
        if batch:
            trk.feeder.emit_descriptors = descriptors
        st, secs = drive(trk, TAP_BLOCKS if batch else HOST_BLOCKS)
        return dict(events=ev, status=st, taps=taps, s=secs)

    # ---- the drive, with the launch counts.
    t_drive = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    host_cells = {}
    for cp, c in caps.items():
        for interp in ("hex", "2stage"):
            t0 = time.perf_counter()
            host_cells[cp, interp] = dedup(cell_search(
                c, FC, f_search_set=fset, backend="numpy", interp=interp))
            out[f"search_{cp}_{interp}_s"] = time.perf_counter() - t0
    tfg = {}
    for cp, cells in groups.items():
        before = dict(kernels.LAUNCHES)
        tfg[cp] = mib_torch.extract_tfg_batch(cells, cap_dev[cp])
        counts[f"tfg_{cp}"] = kernels.LAUNCHES["fd_demod"] \
            - before["fd_demod"]
    before = dict(kernels.LAUNCHES)
    card = events_of("torch", device)
    counts["host_torch"] = {k: kernels.LAUNCHES[k] - before[k]
                            for k in kernels.KERNELS}
    numpy_run = events_of("numpy", device)
    before = dict(kernels.LAUNCHES)
    br.fd_demod_stream = size_tap
    try:
        sample = {"python": events_of("torch", device, batch=True,
                                      descriptors=False)}
    finally:
        br.fd_demod_stream = orig_fd
    sample["native"] = events_of("torch", device, batch=True,
                                 feeder="native", descriptors=False)
    counts["sample"] = {k: kernels.LAUNCHES[k] - before[k]
                        for k in kernels.KERNELS}
    torch.cuda.synchronize()
    out["launches"] = lc = dict(kernels.LAUNCHES)
    out["drive_s"] = time.perf_counter() - t_drive
    print(f"host path launches: {json.dumps(lc)} ({out['drive_s']:.1f} s; "
          f"extract_tfg_batch fd_demod launches per CP group "
          f"{[counts['tfg_' + cp] for cp in caps]}; host tracker with the "
          f"card's searcher {json.dumps(counts['host_torch'])}; the engine "
          f"on sample-carrying PDUs {json.dumps(counts['sample'])})",
          flush=True)
    for name in HOST_KERNELS:
        check(lc[name] > 0, f"{name} launched {lc[name]} time(s) on the "
              "host path")
    check(all(counts[f"tfg_{cp}"] == 1 for cp in caps),
          "extract_tfg_batch launches K4's MIB mode once per CP group: "
          f"{[counts['tfg_' + cp] for cp in caps]}")
    check(all(counts["host_torch"][k] > 0
              for k in ("xcorr_fold", "fd_demod", "viterbi"))
          and counts["host_torch"]["fd_demod_stream"] == 0,
          "LTETracker(batch=False, backend='torch'): its searcher launches "
          "K1, K4 (MIB mode) and K5, and no engine runs: "
          f"{json.dumps(counts['host_torch'])}")
    check(counts["sample"]["fd_demod_stream"] > 0,
          "the engine on sample-carrying PDUs launches K4's stream mode "
          f"{counts['sample']['fd_demod_stream']} time(s)")

    # ---- the float64 search against the card's.
    for (cp, interp), cells in host_cells.items():
        want = found[cp]
        same = len(cells) == len(want) and all(
            [getattr(a, f) for f in CELL_FIELDS]
            == [getattr(b, f) for f in CELL_FIELDS]
            and abs(a.freq_superfine - b.freq_superfine) < 0.5
            for a, b in zip(cells, want))
        check(same, f"cell_search(backend='numpy', interp={interp!r}) on "
              f"the {cp} CP capture ({out[f'search_{cp}_{interp}_s']:.1f} "
              f"s): {[(c.n_id_cell(), c.n_rb_dl, c.sfn) for c in cells]} "
              "equal the card's cells and MIB fields, freq_superfine "
              "within 0.5 Hz: "
              f"{[round(c.freq_superfine, 4) for c in cells]} / "
              f"{[round(c.freq_superfine, 4) for c in want]}")

    # ---- the full grid against the float64 host grid, then K4 there.
    fd_full = {}
    for cp, cells in groups.items():
        grid, ts, ok = tfg[cp]
        n_ofdm = 854 if cp == "normal" else 732
        ts_err = tfg_err = 0.0
        for b, cell in enumerate(cells):
            tfg_h, ts_h = extract_tfg(cell, caps[cp], FC, FC, 1.92e6)
            ts_err = max(ts_err, float(np.abs(ts[b] - ts_h).max()))
            tfg_err = max(tfg_err, float(np.abs(grid[b] - tfg_h).max()
                                         / np.abs(tfg_h).max()))
        check(grid.shape == (HOST_TFG_B, n_ofdm, 72) and ok.all()
              and ts_err <= 1e-9 and tfg_err <= 2e-3,
              f"extract_tfg_batch {cp} CP, B={HOST_TFG_B}: {grid.shape}, ok "
              f"{int(ok.sum())}/{HOST_TFG_B}; against the float64 host "
              f"extract_tfg per cell: timestamps within {ts_err:.2e} (want "
              f"<= 1e-9), grid within {tfg_err:.3e} x max (want <= 2e-3)")
        plan = mib_torch.mib_plan(cells, len(caps[cp]))
        args = mib_torch.fd_demod_inputs(plan, dev, full_grid=True)
        got = fd_demod(cap_dev[cp], *args)
        want = fd_demod_plain(cap_dev[cp], *args)
        err, mx = float((got - want).abs().max()), float(want.abs().max())
        n = args[0].shape[0]
        check(err <= 1e-4 * mx, f"fd_demod on the full grid ({cp} CP, "
              f"N={n}): max abs err {err:.3e} (tolerance 1e-4 * max "
              f"{mx:.3e})")
        t_k = cuda_ms(lambda: fd_demod(cap_dev[cp], *args))
        t_p = cuda_ms(lambda: fd_demod_plain(cap_dev[cp], *args))
        t_call = host_ms(lambda: mib_torch.extract_tfg_batch(cells,
                                                             cap_dev[cp]))
        b_ms = bound(n * (FFT128_FLOPS + 128 * 8 + 72 * 16),
                     8 * len(caps[cp]) + n * 4 * 4 + 4 * 72 + n * 72 * 8)
        t_fft = fd_yardsticks(n)[0]
        fd_full[cp] = dict(n=n, ms=t_k, plain_ms=t_p, bound_ms=b_ms[0],
                           bound_by=b_ms[1], library_ms=t_fft, err=err,
                           call_ms=t_call)
        print(f"extract_tfg_batch {cp} CP at B={HOST_TFG_B}: {t_call:.3f} "
              f"ms per call (host clock, median of {REPS}); its fd_demod "
              f"launch N={n}: {t_k:.4f} ms (plain {t_p:.4f} ms, bound "
              f"{b_ms[0]:.4f} ms by {b_ms[1]}, {100 * b_ms[0] / t_k:.1f}%; "
              f"torch.fft.fft (N, 128) {t_fft:.4f} ms; CUDA events, median "
              f"of {REPS}); {card_line()}", flush=True)
    out["fd_full"] = fd_full

    # ---- the host tracker: card searcher against the CPU and numpy.
    st = card["status"]
    got = [(c["n_id_cell"], c["health"]) for c in st["cells"]]
    check(got == [(271, 1.0)] and st["cells"][0]["mib_successes"] > 10,
          f"LTETracker(batch=False, backend='torch') on the card: cells (id, "
          f"health) {got}, MIB decodes "
          f"{[c['mib_successes'] for c in st['cells']]} (want > 10), FO "
          f"{st['frequency_offset']:.4f} Hz ({card['s']:.1f} s for "
          f"{HOST_BLOCKS} blocks)")
    cpu = events_of("torch", "cpu")

    def same_run(a, b, what):
        """The same events (kinds and cells; acquisition frame timing
        within 0.1), cells, MIB decodes and health; FO within 2 Hz, frame
        timing within 0.1 (tests/test_torch_host_tracker.py's bounds
        between the two searchers)."""
        ka = [(k, {x: v for x, v in i.items() if x != "frame_timing"})
              for k, i in a["events"]]
        kb = [(k, {x: v for x, v in i.items() if x != "frame_timing"})
              for k, i in b["events"]]
        fa = [i.get("frame_timing", 0.0) for _, i in a["events"]]
        fb = [i.get("frame_timing", 0.0) for _, i in b["events"]]
        sa, sb = a["status"], b["status"]
        cells = [[(c["n_id_cell"], c["mib_successes"], c["health"])
                  for c in s["cells"]] for s in (sa, sb)]
        d_ft = max([abs(x - y) for x, y in zip(fa, fb)]
                   + [abs(x["frame_timing"] - y["frame_timing"])
                      for x, y in zip(sa["cells"], sb["cells"])], default=0)
        d_fo = abs(sa["frequency_offset"] - sb["frequency_offset"])
        check(ka == kb and cells[0] == cells[1] and d_fo < 2.0
              and d_ft < 0.1,
              f"{what}: events {[k for k, _ in a['events']]} equal: "
              f"{ka == kb}; cells (id, MIB decodes, health) {cells[0]} / "
              f"{cells[1]}; FO {sa['frequency_offset']:.4f} / "
              f"{sb['frequency_offset']:.4f} Hz (within 2); frame timing "
              f"within {d_ft:.2e} (want < 0.1)")

    same_run(card, cpu, "host tracker, the card's searcher against a "
             "device='cpu' run")
    same_run(numpy_run, card, "host tracker, backend='numpy' against "
             "backend='torch' on the card")
    out["host_ms_per_block"] = {
        "torch": 1e3 * card["s"] / HOST_BLOCKS,
        "numpy": 1e3 * numpy_run["s"] / HOST_BLOCKS,
        "engine": 1e3 * trk_s / 400}
    print("host tracker ms per 10,000-sample block at 1 cell (host clock, "
          f"{HOST_BLOCKS} blocks, searcher included): card's searcher "
          f"{out['host_ms_per_block']['torch']:.3f}, numpy searcher "
          f"{out['host_ms_per_block']['numpy']:.3f}; the engine on the card "
          f"{out['host_ms_per_block']['engine']:.3f}; {card_line()}",
          flush=True)

    # ---- the engine on sample-carrying PDUs against descriptor mode.
    d_cells = [(c["n_id_cell"], c["mib_successes"], c["health"])
               for c in desc_run[0]["cells"]]
    for name, run in sample.items():
        same, errs = tap_errors(run["taps"], desc_run[1])
        cells = [(c["n_id_cell"], c["mib_successes"], c["health"])
                 for c in run["status"]["cells"]]
        check(cells == d_cells and same and errs
              and all(e[2] for e in errs.values()),
              f"the engine on sample-carrying PDUs ({name} feeder, "
              f"{TAP_BLOCKS} blocks, {run['s']:.1f} s) against descriptor "
              f"mode: cells {cells} / {d_cells}; taps (n_id, slot, sym) "
              f"equal: {same}; max abs err (of max) " + ", ".join(
                  f"{k} {e[0]:.3e} ({e[1]:.3e})" for k, e in errs.items())
              + f"; FO {run['status']['frequency_offset']:.4f} / "
              f"{desc_run[0]['frequency_offset']:.4f} Hz")
        out[f"sample_{name}_err"] = errs
    big = max(sizes, key=lambda a: a[1].shape[0])
    got, want = fd_demod_stream(*big), fd_demod_stream_plain(*big)
    err, mx = float((got - want).abs().max()), float(want.abs().max())
    check(err <= 1e-4 * mx,
          f"fd_demod_stream on sample-carrying windows (N="
          f"{big[1].shape[0]}, starts 128 k): max abs err {err:.3e} "
          f"(tolerance 1e-4 * max {mx:.3e})")
    out["sample_err"] = err

    # ---- the float64 chain's time per capture against the card's (the
    # chain runs on the host only: no device sync).
    runs_ms = []
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        cell_search(caps["normal"], FC, f_search_set=fset, backend="numpy")
        runs_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    out["search_ms"] = float(np.median(runs_ms))
    print(f"cell_search normal CP, 31 hypotheses: float64 host chain "
          f"{out['search_ms']:.3f} ms per capture (host clock, median of "
          f"{HOST_REPS}: {runs_ms}) against the card's {e2e_ms:.3f} ms "
          f"({out['search_ms'] / e2e_ms:.0f}x); {card_line()}", flush=True)
    return out


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
        from lte_cell_scanner_tpu_torch.ops.fd_demod import (
            MIB_DFT, SubcarrierDFT, fd_demod, fd_demod_plain, fd_demod_stream,
            fd_demod_stream_plain)
        from lte_cell_scanner_tpu_torch.ops.sync_torch import sss_foe_batch
        from lte_cell_scanner_tpu_torch.ops.peak_torch import (
            peak_search_device, peaks_to_cells, r_th1_normalized)
        from lte_cell_scanner_tpu_torch.search.cell_search import (
            cell_search, dedup, generate_search_sets)
        from lte_cell_scanner_tpu_torch.tracker import batch_runtime as br
        from lte_cell_scanner_tpu_torch.tracker.native_feeder import (
            build_native)
        from lte_cell_scanner_tpu_torch.tracker.runtime import (
            LTETracker, playback_source)
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
          f"{len(built)} sources of {len(kernels.KERNELS)} kernels "
          "(parallel nvcc)")
    for name, (sec, log) in built.items():
        print(f"  {name}: {sec:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    t0 = time.perf_counter()
    print(f"native feeder: {build_native()} ({time.perf_counter() - t0:.2f} "
          "s, g++)", flush=True)

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

    def close(got, want, what, rtol=1e-5):
        err = (got - want).abs()
        tol = rtol * want.abs() + 1e-6 * want.abs().max()
        check(bool((err <= tol).all()),
              f"{what}: max abs err {float(err.max()):.3e} (tolerance rtol "
              f"{rtol:g} + atol 1e-6 * max {float(want.abs().max()):.3e})")
        return float(err.max())

    def fold_vs_plain(c2, fset, what, rtol=1e-5, precision="f32"):
        plan = xcorr_torch.scan_plan(c2.shape[1], fset, FC, FC, 1.92e6,
                                     precision=precision)
        tpl = torch.from_numpy(plan.tpl).to(dev)
        starts = torch.from_numpy(plan.starts).to(dev)
        got = xcorr_torch.xcorr_fold(c2, tpl, starts, plan.n_comb_xc)
        want = xcorr_torch.xcorr_fold_plain(c2, tpl, starts, plan.n_comb_xc
                                            ).view(len(fset), 3, -1
                                                   ).permute(1, 2, 0)
        torch.cuda.synchronize()
        return got, close(got, want, f"xcorr_fold {what} n_f={len(fset)} "
                          f"n_comb={plan.n_comb_xc}", rtol)

    def fold3_inputs(n, fset, precision="f32"):
        """K3's inputs as xcorr_core hands them, for the first n samples."""
        plan = xcorr_torch.scan_plan(n, fset, FC, FC, 1.92e6, layout="tea3",
                                     precision=precision)
        return (plan, *xcorr_torch.karatsuba_inputs(
            cap2[:, :n].contiguous(), torch.from_numpy(plan.tpl).to(dev),
            precision), torch.from_numpy(plan.starts).to(dev))

    def fold3_vs_plain(n, fset, what, precision="f32"):
        plan, c3, tpl3, starts = fold3_inputs(n, fset, precision)
        got = xcorr_torch.xcorr_fold3(c3, tpl3, starts, plan.n_comb_xc)
        want = xcorr_torch.xcorr_fold3_plain(c3, tpl3, starts, plan.n_comb_xc
                                             ).view(len(fset), 3, -1
                                                    ).permute(1, 2, 0)
        torch.cuda.synchronize()
        name = "xcorr_fold3_bf16" if precision == "bf16" else "xcorr_fold3"
        return got, close(got, want, f"{name} {what} n_f={len(fset)} "
                          f"n_comb={plan.n_comb_xc}")

    scan_err, scan3_err = {}, {}
    for label, fset in (("31-hyp", fset31),
                        ("241-hyp", np.arange(-120, 121) * 5e3)):
        got, scan_err[label] = fold_vs_plain(cap2, fset, label)
        # The Karatsuba kernel: against its plain version, and against the
        # 2x2 kernel at the JAX package's tea3-vs-roll tolerance (the same
        # bound: tests/test_xcorr_pallas.py).
        got3, scan3_err[label] = fold3_vs_plain(n_cap, fset, label)
        close(got3, got, f"xcorr_fold3 {label} vs the xcorr_fold kernel")
        del got, got3
    # K3's bf16 mode: one bf16 product per tap on the bf16-rounded planes
    # and bank, exact products summed in float32.
    _, scan3_err["bf16"] = fold3_vs_plain(n_cap, fset31, "31-hyp", "bf16")
    # Both kernels' other shapes: cell_search's default grid (one
    # hypothesis), a group padded from 17, an unsorted grid (wide fold
    # spreads within a group: the span is staged in several passes), a
    # capture of 6 folds; and K1 on bf16-rounded inputs, where lo = 0 and
    # the products are exact (the sums still run in another order).
    for what, n, fset, kw in (
            ("1-hyp", n_cap, np.array([0.0]), {}),
            ("17-hyp", n_cap, np.arange(-8, 9) * 5e3, {}),
            ("241-hyp unsorted", n_cap, np.random.default_rng(1).permutation(
                np.arange(-120, 121)) * 5e3, {}),
            ("short capture", 60000, fset31, {}),
            ("bf16-rounded", n_cap, fset31,
             dict(rtol=1e-6, precision="bf16"))):
        c2 = cap2[:, :n].contiguous()
        if kw:
            c2 = xcorr_torch.round_bf16(c2)
        else:
            fold3_vs_plain(n, fset, what)
        fold_vs_plain(c2, fset, what, **kw)

    # The MIB batch of 64 candidates: the capture's detected cell at 64
    # timings and frequencies around it.
    plan31, tpl31, starts31 = scan_inputs(fset31)
    _, cap3, tpl31_3, _ = fold3_inputs(n_cap, fset31)
    _, cap3_bf, tpl31_3bf, _ = fold3_inputs(n_cap, fset31, "bf16")
    packed, single, _ = xcorr_torch.xcorr_core(cap2, plan31, 2)
    table = peak_search_device(packed, single,
                               r_th1_normalized(plan31.n_comb_xc, 2), 2)
    k1_accuracy(xcorr_torch, cap2, plan31, single, packed, table, 2)
    k3_accuracy(xcorr_torch, cap3, tpl31_3, starts31, plan31.n_comb_xc)
    peaks = peaks_to_cells(table.cpu().numpy(), fset31, FC, FC)
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

    # The tracker's kernels on the inputs of real full-width cycles: the
    # capacity engine's warm-up cycles, with the symbol demod's and the
    # Viterbi decoder's arguments recorded.
    t0 = time.perf_counter()
    n_cycles = WARM_CYCLES + TIMED_CYCLES + PROFILED_CYCLES
    pdus, raw, tracked = harvest_pdus(n_cycles * int(CHUNK_MS * 14))
    check([c.n_id_cell for c in tracked] == [271],
          f"capacity harvest: the tracker on the card tracks "
          f"{[c.n_id_cell for c in tracked]}, want [271]")
    cap_run = CapacityRun(pdus, raw, tracked[0])
    rec = {}
    orig_fd, orig_dec = br.fd_demod_stream, br.lte_conv_decode_batch

    def tap_fd(*args):
        rec["fd"] = tuple(a.clone() for a in args)
        return orig_fd(*args)

    def tap_dec(d_llr):
        if d_llr.shape[0] > rec.get("dec", d_llr[:0]).shape[0]:
            rec["dec"] = d_llr.clone()
        return orig_dec(d_llr)

    br.fd_demod_stream, br.lte_conv_decode_batch = tap_fd, tap_dec
    try:
        for _ in range(WARM_CYCLES):
            cap_run.cycle()
    finally:
        br.fd_demod_stream, br.lte_conv_decode_batch = orig_fd, orig_dec
    torch.cuda.synchronize()
    print(f"tracker capacity set-up: {len(pdus)} PDUs harvested, "
          f"{WARM_CYCLES} warm-up cycles of {CAP_CELLS} cells x "
          f"{CHUNK_MS:.0f} ms, {time.perf_counter() - t0:.1f} s", flush=True)
    str_args = rec["fd"]
    n_str = str_args[1].shape[0]
    got = fd_demod_stream(*str_args)
    want = fd_demod_stream_plain(*str_args)
    str_err = float((got - want).abs().max())
    str_max = float(want.abs().max())
    del got, want
    check(n_str == CAP_CELLS * cap_run.chunk and str_err <= 1e-4 * str_max,
          f"fd_demod_stream N={n_str} (stream {str_args[0].shape[0]} "
          f"samples): max abs err {str_err:.3e} (tolerance 1e-4 * max "
          f"{str_max:.3e})")
    dec = rec["dec"]
    n_trk_cw = dec.shape[0]
    llr_trk = dec.to(torch.float32).transpose(1, 2).reshape(
        n_trk_cw, dec.shape[2] // 4, 12).permute(1, 2, 0).contiguous()
    bad = (viterbi.viterbi_tl(llr_trk) != viterbi.viterbi_tl_plain(llr_trk)
           ).any(dim=0).nonzero().flatten()
    check(len(bad) == 0,
          f"viterbi at the tracker batch L={n_trk_cw}: {len(bad)} "
          "codeword(s) differ from the plain version (bits must be "
          "identical)")

    # Edge starts in both modes of the symbol demod, and tie-heavy LLRs
    # for the Viterbi decoder, on synthetic inputs made from a seed.
    rng = np.random.default_rng(0)
    for mode, samples in (("fd_demod", cap_ri), ("fd_demod_stream",
                                                  str_args[0])):
        idx = torch.from_numpy(edge_starts(samples.shape[0], rng)).to(dev)
        n_e = idx.shape[0]
        prm = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.uniform(-0.05, 0.05, n_e), rng.uniform(-np.pi, np.pi, n_e),
            rng.uniform(-2, 2, n_e)))
        if mode == "fd_demod":
            got = fd_demod(samples, idx, *prm, MIB_DFT)
            want = fd_demod_plain(samples, idx, *prm, MIB_DFT)
        else:
            got = fd_demod_stream(samples, idx, *prm)
            want = fd_demod_stream_plain(samples, idx, *prm)
        err, mx = float((got - want).abs().max()), float(want.abs().max())
        check(err <= 1e-4 * mx,
              f"{mode} at {n_e} edge starts (0, every start mod 128, the "
              f"last row, past the end of the {samples.shape[0]} samples): "
              f"max abs err {err:.3e} (tolerance 1e-4 * max {mx:.3e})")
    llr_tie = torch.from_numpy(rng.integers(-2, 3, (10, 12, 768)).astype(
        np.float32)).to(dev)
    bad = (viterbi.viterbi_tl(llr_tie) != viterbi.viterbi_tl_plain(llr_tie)
           ).any(dim=0).nonzero().flatten()
    check(len(bad) == 0,
          f"viterbi on tie-heavy integer LLRs in -2..2, L=768: {len(bad)} "
          "codeword(s) differ from the plain version (bits must be "
          "identical)")

    # The wrappers refuse what the kernels do not take.
    def refuses(fn) -> bool:
        try:
            fn()
        except ValueError:
            return True
        return False

    check(refuses(lambda: xcorr_torch.xcorr_fold(
        cap2.double(), tpl31, starts31, plan31.n_comb_xc))
          and refuses(lambda: xcorr_torch.xcorr_fold3(
              cap2, tpl31_3, starts31, plan31.n_comb_xc))
          and refuses(lambda: xcorr_torch.xcorr_fold3(
              cap3, tpl31, starts31, plan31.n_comb_xc))
          and refuses(lambda: xcorr_torch.xcorr_fold3(
              cap3, tpl31_3bf, starts31, plan31.n_comb_xc))
          and refuses(lambda: fd_demod(cap_ri, demod_args[0][::2],
                                       *demod_args[1:]))
          and refuses(lambda: fd_demod(cap_ri, *demod_args[:4],
                                       SubcarrierDFT(MIB_DFT.bins[:70], 0)))
          and refuses(lambda: viterbi.viterbi_tl(llr_tl[:, :6]))
          and refuses(lambda: fd_demod_stream(str_args[0].float(),
                                              *str_args[1:]))
          and refuses(lambda: fd_demod_stream(str_args[0],
                                              str_args[1].long(),
                                              *str_args[2:])),
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
    print(f"search path launches: {json.dumps(launches)}")
    for name in SEARCH_KERNELS:
        check(launches[name] > 0, f"{name} launched {launches[name]} "
              "time(s) on the search path")
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

    # The tracker path: 400 blocks (2.08 s) of the simulated cell.
    sig_trk = synthetic_capture(n_subframes=400, **TRACKER_SIG)
    # The stream launches' sizes are recorded on the way (a tap that
    # calls the wrapper once per call).
    trk_sizes = []

    def size_tap(*args):
        trk_sizes.append(int(args[1].shape[0]))
        return orig_fd(*args)

    t0 = time.perf_counter()
    br.fd_demod_stream = size_tap
    kernels.reset_launches()
    try:
        trk = LTETracker(FC, initial_freq_offset=4000.0)
        trk.run(playback_source(sig_trk), max_blocks=400)
        torch.cuda.synchronize()
        trk_launches = dict(kernels.LAUNCHES)
    finally:
        br.fd_demod_stream = orig_fd
    t_trk = time.perf_counter() - t0
    trk_med = int(np.median(trk_sizes))
    print(f"tracker path launches: {json.dumps(trk_launches)} "
          f"({t_trk:.1f} s for 400 blocks); stream launch sizes: median "
          f"{trk_med}, min {min(trk_sizes)}, max {max(trk_sizes)} windows",
          flush=True)
    for name in TRACKER_KERNELS:
        check(trk_launches[name] > 0, f"{name} launched "
              f"{trk_launches[name]} time(s) on the tracker path")
    st = trk.status()
    got = [(c["n_id_cell"], c["health"]) for c in st["cells"]]
    check(got == [(271, 1.0)] and st["cells"][0]["mib_successes"] > 10
          and abs(st["frequency_offset"] - 4000.0) < 20.0,
          f"tracker on the card: cells (id, health) {got}, MIB decodes "
          f"{[c['mib_successes'] for c in st['cells']]} (want > 10), FO "
          f"{st['frequency_offset']:.3f} Hz (want 4000 +- 20)")
    ref = LTETracker(FC, initial_freq_offset=4000.0, device="cpu")
    ref.run(playback_source(sig_trk), max_blocks=400)
    rs = ref.status()
    same = ([c["n_id_cell"] for c in st["cells"]]
            == [c["n_id_cell"] for c in rs["cells"]]) and all(
        a["mib_successes"] == b["mib_successes"]
        and abs(a["frame_timing"] - b["frame_timing"]) < 0.1
        for a, b in zip(st["cells"], rs["cells"]))
    check(same and abs(st["frequency_offset"] - rs["frequency_offset"]) < 2,
          "tracker: the card's run equals the plain versions' on the CPU "
          "(cells, MIB decodes; FO within 2 Hz: card "
          f"{st['frequency_offset']:.4f}, CPU {rs['frequency_offset']:.4f}; "
          f"frame timing within 0.1: card "
          f"{[round(c['frame_timing'], 4) for c in st['cells']]}, CPU "
          f"{[round(c['frame_timing'], 4) for c in rs['cells']]})")

    # The tools path.
    t0 = time.perf_counter()
    kernels.reset_launches()
    tools = tools_path(caps, (trk_med, 1050, n_str))
    torch.cuda.synchronize()
    tools_launches = dict(kernels.LAUNCHES)
    print(f"tools path launches: {json.dumps(tools_launches)} "
          f"({time.perf_counter() - t0:.1f} s)")
    for name in TOOLS_KERNELS:
        check(tools_launches[name] > 0, f"{name} launched "
              f"{tools_launches[name]} time(s) on the tools path")

    # The sweep path.
    t0 = time.perf_counter()
    sweep = sweep_path(fset31, close)
    print(f"sweep path: {time.perf_counter() - t0:.1f} s", flush=True)
    sweep_launches = {k: sweep["launches"]["whole"][k]
                      + sweep["launches"]["pipelined"][k]
                      for k in kernels.KERNELS}

    # The wideband path.
    t0 = time.perf_counter()
    wband = wideband_path(fset31, close)
    print(f"wideband path: {time.perf_counter() - t0:.1f} s", flush=True)
    # The multi-device paths.
    t0 = time.perf_counter()
    multi = multi_path(sweep, wband, fset31)
    print(f"multi path: {time.perf_counter() - t0:.1f} s", flush=True)
    path_launches = {"search": launches, "tracker": trk_launches,
                     "tools": tools_launches, "sweep": sweep_launches,
                     "wideband": wband["launches"],
                     "multi": multi["launches"]}

    # ---- 4. timing.
    t_scan = cuda_ms(lambda: xcorr_torch.xcorr_fold(
        cap2, tpl31, starts31, plan31.n_comb_xc))
    t_scan_plain = cuda_ms(lambda: xcorr_torch.xcorr_fold_plain(
        cap2, tpl31, starts31, plan31.n_comb_xc))
    # The Karatsuba trade: K1 and both K3 modes at 31 and 241 hypotheses,
    # in turns in this call.
    fset241 = np.arange(-120, 121) * 5e3
    plan241, tpl241, starts241 = scan_inputs(fset241)
    _, _, tpl241_3, _ = fold3_inputs(n_cap, fset241)
    _, _, tpl241_3bf, _ = fold3_inputs(n_cap, fset241, "bf16")
    trade = {}
    for n_f, args1, args3, args3bf in (
            (31, (cap2, tpl31, starts31, plan31.n_comb_xc),
             (cap3, tpl31_3, starts31, plan31.n_comb_xc),
             (cap3_bf, tpl31_3bf, starts31, plan31.n_comb_xc)),
            (241, (cap2, tpl241, starts241, plan241.n_comb_xc),
             (cap3, tpl241_3, starts241, plan241.n_comb_xc),
             (cap3_bf, tpl241_3bf, starts241, plan241.n_comb_xc))):
        n_comb = args1[3]
        trade[n_f] = {
            "K1": (cuda_ms(lambda: xcorr_torch.xcorr_fold(*args1)),
                   scan_tc_flops(n_f, n_comb) / PEAK_TF32_FLOPS * 1e3),
            "K3 f32": (cuda_ms(lambda: xcorr_torch.xcorr_fold3(*args3)),
                       scan3_tc_flops(n_f, n_comb, 3) / PEAK_TF32_FLOPS
                       * 1e3),
            "K3 bf16": (cuda_ms(lambda: xcorr_torch.xcorr_fold3(*args3bf)),
                        scan3_tc_flops(n_f, n_comb, 1) / PEAK_BF16_FLOPS
                        * 1e3)}
        print(f"scan kernels at {n_f} hypotheses (CUDA events, median of "
              f"{REPS}; tensor-core bound of the function): " + ", ".join(
                  f"{k} {t:.4f} ms (bound {b:.4f} ms, {100 * b / t:.1f}%)"
                  for k, (t, b) in trade[n_f].items()))
    t_scan3, t_scan3_bf = trade[31]["K3 f32"][0], trade[31]["K3 bf16"][0]
    g_dev, g_launch = guard_us(dev)
    print(f"device guard per launch (host): torch.cuda.device {g_dev:.3f} "
          f"us, launch_device {g_launch:.3f} us")
    del tpl241, starts241, tpl241_3, tpl241_3bf
    n_ch = 3 * len(fset31)
    w_re = tpl31[:, :, 0].reshape(n_ch, -1)
    w_im = tpl31[:, :, 1].reshape(n_ch, -1)
    weight = torch.cat([torch.stack([w_re, -w_im], 1),
                        torch.stack([w_im, w_re], 1)], 0)
    t_conv = cuda_ms(lambda: torch.nn.functional.conv1d(cap2[None], weight))
    t_scan3_plain = cuda_ms(lambda: xcorr_torch.xcorr_fold3_plain(
        cap3, tpl31_3, starts31, plan31.n_comb_xc))
    t_scan3_bf_plain = cuda_ms(lambda: xcorr_torch.xcorr_fold3_plain(
        cap3_bf, tpl31_3bf, starts31, plan31.n_comb_xc))
    # K3's yardstick: its three real correlations as one grouped
    # convolution (plane p of the capture against plane p of the bank),
    # in the mode's dtype; no recombination and no fold.
    t_conv3 = {}
    for mode, (c3, t3) in (("f32", (cap3, tpl31_3)),
                           ("bf16", (cap3_bf, tpl31_3bf))):
        w3 = t3.reshape(n_ch, 3, -1).transpose(0, 1).reshape(3 * n_ch, 1, -1)
        t_conv3[mode] = cuda_ms(lambda: torch.nn.functional.conv1d(
            c3[None], w3, groups=3))
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

    trk_cli = subprocess.run(
        [sys.executable, "-m", "lte_cell_scanner_tpu_torch.tracker.cli",
         "-f", "739e6", "--simulate", "--blocks", "400"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    print(trk_cli.stdout.strip().splitlines()[-3:] if trk_cli.stdout
          else trk_cli.stderr[-2000:])
    check(trk_cli.returncode == 0 and any(
        line.split()[:1] == ["271"] for line in trk_cli.stdout.splitlines()),
          "the tracker CLI (--simulate --blocks 400, on the card) tracks "
          "cell 271")

    # The tracker's capacity run, continuing the warm engine of phase 2;
    # the tap keeps the last timed cycle's program arguments.
    from lte_cell_scanner_tpu_torch.tools import bench_tracker

    walls, splits = [], []
    with bench_tracker.ProgramTap() as cap_tap:
        for _ in range(TIMED_CYCLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cap_run.cycle()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append(dict(cap_run.stage_s))
    cyc_ms = float(np.median(walls))
    cells_rt = CAP_CELLS * cap_run.signal_s / (cyc_ms / 1e3)
    print(f"tracker capacity: {CAP_CELLS} cells x {CHUNK_MS:.0f} ms cycles: "
          f"{cyc_ms:.3f} ms per cycle (median of {TIMED_CYCLES}: "
          f"{', '.join(f'{w:.3f}' for w in walls)}), {cells_rt:.2f} cells "
          "in realtime")
    labels = dict.fromkeys(label for _, label in CapacityRun.STAGES)
    print("  stages (host clock, median ms per cycle; a stage that waits "
          "for a device result carries the wait): " + ", ".join(
              f"{lb} {np.median([sp.get(lb, 0.0) for sp in splits]) * 1e3:.3f}"
              for lb in labels))
    # The device-bound capacity: the last timed cycle replayed without
    # the host (CUDA graphs), eagerly and under the profiler.
    t0 = time.perf_counter()
    cap_bound = bench_tracker.device_bound(cap_tap, CAP_CELLS,
                                           cap_run.signal_s)
    print(f"tracker capacity, device bound ({CAP_CELLS} cells x "
          f"{CHUNK_MS:.0f} ms, the last timed cycle replayed; "
          f"{time.perf_counter() - t0:.1f} s): device_ms_per_cycle "
          f"{cap_bound['device_ms_per_cycle']:.4f} (CUDA graphs), "
          f"replay_ms_per_cycle_eager "
          f"{cap_bound['replay_ms_per_cycle_eager']:.4f}, "
          f"profiler_kernel_ms_per_cycle "
          f"{cap_bound['profiler_kernel_ms_per_cycle']:.4f}, "
          f"cells_realtime_device {cap_bound['cells_realtime_device']:.1f} "
          f"(wall {cells_rt:.2f}), MIB batches per cycle "
          f"{cap_bound['mib_batches_per_cycle']:.3f}")
    eq = cap_bound["replay_bits_equal"]
    check(all(eq.values()),
          f"tracker capacity replay: graph vs eager vs tapped cycle bit-equal "
          f"({eq})")
    check(0 < cap_bound["device_ms_per_cycle"] < cyc_ms
          and np.isfinite(cap_bound["cells_realtime_device"]),
          f"tracker capacity, device bound: "
          f"{cap_bound['device_ms_per_cycle']:.4f} ms per cycle, finite and "
          f"below the {cyc_ms:.3f} ms wall")
    device_busy(cap_run.cycle, cyc_ms, warm=False)
    print(f"sweep, whole stack B={SWEEP_B}:")
    device_busy(*sweep["profile"])
    print("wideband sweep, B=296:")
    device_busy(*wband["profile"])
    print(f"whole stack B={SWEEP_B}, 2 shards on cuda:0:")
    device_busy(*multi["profile"])
    mibs = [c.mib_decode_successes for c in cap_run.cells]
    check(min(mibs) > 0 and all(c.health == 1.0 for c in cap_run.cells),
          f"capacity run: every replica decodes its MIB (min {min(mibs)}, "
          f"total {sum(mibs)} decodes) at health 1.0")
    t_str = cuda_ms(lambda: fd_demod_stream(*str_args))
    t_str_plain = cuda_ms(lambda: fd_demod_stream_plain(*str_args))
    t_fft, t_mm = {}, {}
    for n in (n_win, n_str):
        t_fft[n], t_mm[n] = fd_yardsticks(n)
        print(f"K4 yardsticks at N={n} (partial: no gather, rotations or "
              f"bin selection): torch.fft.fft (N, 128) complex64 "
              f"{t_fft[n]:.4f} ms, f32 matmul (N, 256) @ (256, 144) "
              f"{t_mm[n]:.4f} ms")
    t_vit_trk = cuda_ms(lambda: viterbi.viterbi_tl(llr_trk))
    t_vit_trk_plain = cuda_ms(lambda: viterbi.viterbi_tl_plain(llr_trk))

    n_f, n_comb = len(fset31), plan31.n_comb_xc
    scan_bytes = 4 * (2 * n_cap + n_ch * 2 * 137 + n_f * n_comb
                      + n_ch * 9600)
    # K1 on the tensor cores: three TF32 products per MAC of the function.
    scan_b = bound(scan_tc_flops(n_f, n_comb), scan_bytes, PEAK_TF32_FLOPS)
    # The same function's f32 FMA count on the CUDA cores (the bound of a
    # CUDA-core kernel).
    scan_fma_b = bound(n_ch * 9600 * n_comb * (137 * 8 + 3), scan_bytes)
    # K3: three real products per complex tap, three TF32 products each
    # in the float32 mode, one bf16 product in the bf16 mode. Its old bound
    # on the CUDA cores: three FMAs per tap, then re = k1 - k2,
    # im = k3 - k1 - k2 and |xc|^2 accumulated (7 flops); the capture sum
    # a+b is an input.
    def scan3_bytes(size):
        return (size * (3 * n_cap + n_ch * 3 * 137)
                + 4 * (n_f * n_comb + n_ch * 9600))

    scan3_b = bound(scan3_tc_flops(n_f, n_comb, 3), scan3_bytes(4),
                    PEAK_TF32_FLOPS)
    scan3_bf_b = bound(scan3_tc_flops(n_f, n_comb, 1), scan3_bytes(2),
                       PEAK_BF16_FLOPS)
    scan3_fma_b = bound(n_ch * 9600 * n_comb * (137 * 6 + 7), scan3_bytes(4))
    # K4: the FFT's flops, the pre-rotation (phase and complex product, 8
    # per sample, plus 4 for the u8 conversion) and per bin the shift
    # factor and the post-rotation (16); bins (72 i32) as the table.
    fd_b = bound(n_win * (FFT128_FLOPS + 128 * 8 + 72 * 16),
                 8 * n_cap + n_win * 4 * 4 + 4 * 72 + n_win * 72 * 8)
    str_b = bound(n_str * (FFT128_FLOPS + 128 * 12 + 72 * 16),
                  str_args[0].numel() + n_str * 4 * 4 + 4 * 72
                  + n_str * 72 * 8)

    def vit_bound(llr):
        # 11 adds per branch sum; an add and a max per finite candidate:
        # of the joint pass's 16 per (state, start), steps 0 and 1 have 1
        # and 4, and from its one start the replay's 64 states have 16 x
        # 1, then 64 x 4, then 64 x 16; the sign mask and BITS tables.
        n_steps, _, n = llr.shape
        joint = 64 * 64 * (1 + 4 + 16 * (n_steps - 2))
        replay = 16 + 64 * 4 + 64 * 16 * (n_steps - 2)
        return bound(n * (n_steps * 1024 * 11 + 2 * (joint + replay)),
                     4 * (llr.numel() + 1024 + 1024 * 4 + 4 * n_steps * n))

    vit_b, vit_trk_b = vit_bound(llr_tl), vit_bound(llr_trk)

    # The tracker as its users run it, after the timings above: the CLI's
    # file playback, the native feeder and the CE tap.
    t0 = time.perf_counter()
    play = playback_path()
    print(f"playback path: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    native = native_path(sig_trk)
    print(f"native feeder path: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    host = host_path(caps, fset31, found, sig_trk, native["py"],
                     e2e["normal"], t_trk)
    print(f"host path: {time.perf_counter() - t0:.1f} s", flush=True)
    path_launches.update(playback=play["launches"],
                         native=native["launches"], host=host["launches"])
    print(f"viterbi at the tracker batch L={n_trk_cw}: {t_vit_trk:.4f} ms "
          f"(plain {t_vit_trk_plain:.4f} ms, bound {vit_trk_b[0]:.4f} ms by "
          f"{vit_trk_b[1]})")
    rows = [
        dict(name="xcorr_fold", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/xcorr_fold.cu",
             replaces="lte_cell_scanner_tpu/ops/xcorr_pallas.py:124 (K1), "
                      "lte_cell_scanner_tpu/ops/xcorr_pallas.py:51 (K2)",
             max_abs_err=scan_err["31-hyp"],
             ms=t_scan, plain_ms=t_scan_plain, bound_ms=scan_b[0],
             bound_by=scan_b[1], library_ms=t_conv,
             fma_bound_ms=scan_fma_b[0]),
        dict(name="xcorr_fold3", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/xcorr_fold.cu",
             replaces="lte_cell_scanner_tpu/ops/xcorr_pallas.py:174 (K3)",
             max_abs_err=scan3_err["31-hyp"], ms=t_scan3,
             plain_ms=t_scan3_plain, bound_ms=scan3_b[0],
             bound_by=scan3_b[1], library_ms=t_conv3["f32"],
             fma_bound_ms=scan3_fma_b[0]),
        dict(name="xcorr_fold3_bf16", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/xcorr_fold.cu",
             replaces="lte_cell_scanner_tpu/ops/xcorr_pallas.py:174 (K3, "
                      "bf16 mode)",
             max_abs_err=scan3_err["bf16"], ms=t_scan3_bf,
             plain_ms=t_scan3_bf_plain, bound_ms=scan3_bf_b[0],
             bound_by=scan3_bf_b[1], library_ms=t_conv3["bf16"],
             fma_bound_ms=scan3_fma_b[0]),
        dict(name="fd_demod", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/fd_demod.cu",
             replaces="lte_cell_scanner_tpu/ops/fd_demod_pallas.py:58 (K4)",
             max_abs_err=fd_err, ms=t_fd,
             plain_ms=t_fd_plain, bound_ms=fd_b[0], bound_by=fd_b[1],
             library_ms=t_fft[n_win]),
        dict(name="fd_demod_stream", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/fd_demod.cu",
             replaces="lte_cell_scanner_tpu/ops/fd_demod_pallas.py:58 (K4, "
                      "tracker mode)",
             max_abs_err=str_err,
             ms=t_str, plain_ms=t_str_plain, bound_ms=str_b[0],
             bound_by=str_b[1], library_ms=t_fft[n_str]),
        dict(name="viterbi", route="cuda",
             source="lte_cell_scanner_tpu_torch/csrc/viterbi.cu",
             replaces="lte_cell_scanner_tpu/models/viterbi_pallas.py:63 (K5)",
             max_abs_err=vit_err, ms=t_vit,
             plain_ms=t_vit_plain, bound_ms=vit_b[0], bound_by=vit_b[1],
             library_ms=None),
    ]
    # Each kernel's launches over the paths' runs, and by path.
    for r in rows:
        by_path = {p: n[r["name"]] for p, n in path_launches.items()
                   if n[r["name"]]}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    kb = sweep["k1_batch"]
    rows[0].update(batch64_ms=kb["ms"], batch64_single_ms=kb["single_ms"],
                   batch64_plain_ms=kb["plain_ms"],
                   batch64_bound_ms=kb["bound_ms"],
                   batch64_library_ms=kb["conv_ms"],
                   batch64_max_abs_err=sweep["k1_batch_err"])
    kw = wband["k1"]
    rows[0].update(batch296_ms=kw["ms"], batch296_single_ms=kw["single_ms"],
                   batch296_bound_ms=kw["bound_ms"],
                   batch296_max_abs_err=wband["k1_err"])
    rows[0].update(batch32_ms=multi["k1_shard"][SWEEP_B // 2],
                   batch32_bound_ms=kb["bound_ms"] / 2)
    for cp, f in host["fd_full"].items():
        rows[3].update({f"full_grid_{cp}_{k}": v for k, v in f.items()})
    rows[4].update(sample_mode_max_abs_err=host["sample_err"])
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}"
              + (f"; f32 FMA bound {r['fma_bound_ms']:.4f} ms"
                 if "fma_bound_ms" in r else "")
              + (f"; library {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else "") + ")")
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
