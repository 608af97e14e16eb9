"""Tracker capacity benchmark: cells tracked in realtime per card.

The reference tracks ~4 cells x 2 ports in realtime on a dual-core
i7-2640 (doc/LTE-Tracker.html:56-57, BASELINE.md). This benchmark
measures the batched engine (tracker/batch_runtime.py): M tracked cells'
complete per-symbol processing — demod, channel estimation/filtering,
FOE/TOE/AC statistics, sync measurements, PBCH collection and the batched
Viterbi MIB decode with health tracking — driven for a stretch of signal,
reporting how many cells fit in realtime.

The per-cell symbol streams replicate one simulated cell's PDUs (the
arithmetic is identical for any cell content; acquisition is exercised by
the tests, not benchmarked here). Each engine cycle is timed on the host
clock and ends in a device sync; the capacity uses the median cycle.

On the card the tool also reports the device-bound capacity: the engine's
device programs are tapped during the timed cycles (:class:`ProgramTap`),
and one cycle's recorded arguments are replayed without the host — the
demod and stats programs, and the MIB decode at its observed cadence
(MIB batches per cycle) — as CUDA graphs, N replays timed with CUDA
events, the slope between N = 8 and 32 (``device_ms_per_cycle``,
``cells_realtime_device``, ``vs_baseline_device``). Beside it, the same
replay without a graph (``replay_ms_per_cycle_eager``: the device time
plus the host's launches where they do not overlap) and the summed
device-kernel time of one eager replay under torch.profiler
(``profiler_kernel_ms_per_cycle``). The wall, the eager replay and the
graph replay split a cycle into host planning, host launches and device.

Usage: python -m lte_cell_scanner_tpu_torch.tools.bench_tracker \
           [--cells 96] [--seconds 1.2] [--chunk-ms 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from lte_cell_scanner_tpu_torch import kernels
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.tracker import batch_runtime as br
from lte_cell_scanner_tpu_torch.tracker.batch_runtime import (
    BatchTrackerEngine)
from lte_cell_scanner_tpu_torch.tracker.runtime import (LTETracker,
                                                        playback_source)
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell
from lte_cell_scanner_tpu_torch.utils.device import resolve_device

BASELINE_CELLS = 4.0
# The engine's device programs, by the module-level names batch_runtime
# calls them by, and what each one is in a cycle.
PROGRAMS = {"_demod_stream": "demod", "_demod_samples": "demod",
            "_stats": "stats", "lte_conv_decode_batch": "vit"}
# Replay counts of the device-time slope (the JAX tool's chain lengths).
SLOPE_REPS = (8, 32)


def _collect_pdus(seconds: float, device):
    """Run the real tracker once to harvest authentic descriptor PDUs
    plus the raw uint8 stream they index into."""
    n_subframes = int(seconds * 1000) + 400
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=4e3, n_subframes=n_subframes,
                            sfn_start=0, seed=5)
    harvested = []
    raw_blocks = []

    trk = LTETracker(739e6, initial_freq_offset=4000.0, engine_every=20,
                     device=device)
    # Tap the feeder: record every PDU pushed to the first tracked cell.
    orig_push = TrackedCell.push_pdu

    def tap(self, pdu):
        harvested.append(copy.copy(pdu))
        orig_push(self, pdu)

    def tapped_source():
        for blk in playback_source(sig):
            raw_blocks.append(blk)
            yield blk

    TrackedCell.push_pdu = tap
    try:
        n_blocks = int(seconds * 1.92e6 / 10000) + 250
        trk.run(tapped_source(), max_blocks=n_blocks)
    finally:
        TrackedCell.push_pdu = orig_push
    if not trk.cells:
        raise RuntimeError("benchmark signal failed to acquire")
    return harvested, raw_blocks, trk.cells[0]


def measure(cells=96, seconds=1.2, chunk_ms=300.0, verbose=True,
            warm_chunks=2, device=None, replay=True) -> dict:
    """Run the capacity measurement; returns the metric dict (the same
    payload ``main`` prints). ``replay=False`` leaves out the device-bound
    readings (:func:`device_bound`): their torch.profiler run slows the
    process's later launches, so a caller that times more afterwards in
    the same process skips them."""
    dev = resolve_device(device)
    pdus, raw_blocks, proto = _collect_pdus(seconds, dev)
    n_sym_s = proto.n_symb_dl * 2 * 1000
    pdus = pdus[:int(seconds * n_sym_s)]
    chunk = max(1, int(chunk_ms / 1000 * n_sym_s))
    if len(pdus) <= chunk * (int(warm_chunks) + 1):
        # Never let warm-up consume the whole signal: keep >= 2 timed
        # chunks or the measurement degenerates to 0 s.
        chunk = max(1, len(pdus) // (int(warm_chunks) + 2))

    M = cells
    state = GlobalState(fc_requested=739e6, fc_programmed=739e6,
                        fs_programmed=1.92e6, frequency_offset=4000.0)
    # M replicas of the real tracked cell (distinct serials), so the full
    # locked-tracker path runs: MIB decodes succeed.
    cells = [TrackedCell(
        n_id_cell=proto.n_id_cell, n_ports=proto.n_ports,
        cp_type=proto.cp_type, n_rb_dl=proto.n_rb_dl,
        phich_duration=proto.phich_duration,
        phich_resource=proto.phich_resource,
        frame_timing=proto.frame_timing, serial_num=m,
        drop_threshold=float("inf")) for m in range(M)]
    engine = BatchTrackerEngine(state, device=dev)
    for blk in raw_blocks:
        engine.push_raw(blk)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Warm-up: the MIB backlog walks up over the first cycles.
    warm = max(1, int(warm_chunks)) * chunk
    for c in cells:
        c.fifo.extend(pdus[:warm])
    engine.process_all(cells)
    sync()

    fed = warm
    cycle_walls = []
    # Full chunks only, each cycle timed separately: the capacity uses
    # the median cycle, so one slow cycle poisons one sample. The tap
    # keeps the last cycle's program arguments for the device bound.
    with ProgramTap() as tap:
        while fed + chunk <= len(pdus):
            hi = fed + chunk
            sync()
            t1 = time.perf_counter()
            for c in cells:
                c.fifo.extend(pdus[fed:hi])
            engine.process_all(cells)
            sync()
            cycle_walls.append(time.perf_counter() - t1)
            fed = hi
    if not cycle_walls:
        raise RuntimeError("no timed cycle: raise --seconds")
    wall_med = float(np.median(cycle_walls))

    signal_s = (fed - warm) / n_sym_s
    chunk_s = chunk / n_sym_s
    cells_realtime = M * chunk_s / wall_med
    mibs = sum(c.mib_decode_successes for c in cells)
    if verbose:
        print(f"# {M} cells x {signal_s:.2f}s signal in "
              f"{sum(cycle_walls):.2f}s wall (median cycle "
              f"{wall_med:.3f}s, {mibs} MIB decodes)", flush=True)
    return {
        "metric": "tracker_cells_realtime_per_chip",
        "value": cells_realtime,
        "unit": "cells",
        "vs_baseline": cells_realtime / BASELINE_CELLS,
        "cycle_walls_s": cycle_walls,
        "cells": M,
        "chunk_ms": chunk_s * 1e3,
        "mib_decodes": mibs,
        "min_health": min(c.health for c in cells),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        **(device_bound(tap, M, chunk_s, verbose=verbose) if replay
           else {}),
    }


class ProgramTap:
    """While active (a context manager), records the arguments and the
    results of the engine's device programs (:data:`PROGRAMS`) as the
    engine calls them, the newest of each kind in :attr:`rec`, and counts
    the cycles (demod programs) and the MIB batches in :attr:`counts`.
    The module-level names are restored on exit. A program called from
    inside another tapped one (``_demod_samples`` runs ``_demod_stream``)
    is recorded once, as the outer call."""

    def __init__(self):
        self.rec: dict = {}
        self.counts = {"cycles": 0, "mib": 0}
        self._orig: dict = {}
        self._depth = 0

    def __enter__(self) -> "ProgramTap":
        self._orig = {name: getattr(br, name) for name in PROGRAMS}
        for name, kind in PROGRAMS.items():
            setattr(br, name, self._tap(name, kind, self._orig[name]))
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self._orig.items():
            setattr(br, name, fn)

    def _tap(self, name, kind, fn):
        def run(*args):
            self._depth += 1
            try:
                out = fn(*args)
            finally:
                self._depth -= 1
            if self._depth:
                return out
            rec = self.rec
            if kind == "demod":
                self.counts["cycles"] += 1
                rec["demod"], rec["demod_out"] = args, out
                rec["demod_fn"] = name
                rec["demod_cycle"] = self.counts["cycles"]
            elif kind == "stats":
                rec["stats"], rec["stats_out"] = args, out
                rec["stats_cycle"] = self.counts["cycles"]
            else:
                self.counts["mib"] += 1
                rec["vit"], rec["vit_out"] = args[0], out
            return out
        return run


def recorded_cycle(tap: ProgramTap) -> dict:
    """The newest cycle the tap recorded, its tensors cloned: the demod
    and stats programs' arguments and results (of the same cycle), and
    the newest MIB batch's. Raises if the tap holds no whole cycle."""
    rec = tap.rec
    if "demod" not in rec or rec.get("stats_cycle") != rec["demod_cycle"]:
        raise RuntimeError("bench_tracker: the tap holds no cycle with both "
                           "a demod and a stats program")

    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple):
            return tuple(clone(a) for a in v)
        return v

    keep = ("demod", "demod_out", "demod_fn", "stats", "stats_out", "vit",
            "vit_out")
    return {k: clone(rec[k]) for k in keep if k in rec}


def replay_cycle(rec: dict) -> dict:
    """Eager replay of one recorded cycle's device programs: the demod
    program on its arguments, then the stats program on the replayed raw
    CE rows (as the engine feeds it) and its other recorded arguments.
    Returns the programs' results under the keys of
    :func:`tapped_results` (without "vit")."""
    demod = getattr(br, rec["demod_fn"])
    flat, ce = demod(*rec["demod"])
    flat2, td_hist = br._stats(ce, *rec["stats"][1:])
    return {"demod": flat, "ce": ce, "stats": flat2, "td_hist": td_hist}


def replay_mib(rec: dict) -> dict:
    """Eager replay of the recorded MIB batch's decode."""
    return {"vit": br.lte_conv_decode_batch(rec["vit"])}


def tapped_results(rec: dict) -> dict:
    """The results the engine's programs returned in the recorded cycle."""
    out = {"demod": rec["demod_out"][0], "ce": rec["demod_out"][1],
           "stats": rec["stats_out"][0], "td_hist": rec["stats_out"][1]}
    if "vit_out" in rec:
        out["vit"] = rec["vit_out"]
    return out


def same_bits(a: dict, b: dict) -> bool:
    """Whether every tensor of ``a`` has the bits of ``b``'s under the
    same key (NaN included)."""
    def bits(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)

    return all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
               and torch.equal(bits(a[k]), bits(b[k])) for k in a)


def _capture(fn, what: str):
    """fn captured in a CUDA graph after three warm-up calls on a side
    stream (which also make the tables, builds and caches that fn needs
    on first use). Returns (graph, its static outputs, the wrapper
    launches the capture made: the graph's kernels). Raises with the
    reason when the capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except Exception as e:
        raise RuntimeError(f"bench_tracker: the {what} cannot be captured "
                           f"in a CUDA graph: {e}") from e
    launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                if n != before[k]}
    return graph, out, launched


def _slope_ms(run, trials: int = 3) -> float:
    """Device ms per call of ``run(n)`` (n calls): CUDA events around n =
    SLOPE_REPS calls, the slope between the two, median of ``trials``."""
    lo, hi = SLOPE_REPS
    run(2)
    slopes = []
    for _ in range(trials):
        ms = {}
        for n in (lo, hi):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run(n)
            end.record()
            end.synchronize()
            ms[n] = start.elapsed_time(end)
        slopes.append((ms[hi] - ms[lo]) / (hi - lo))
    return float(np.median(slopes))


def _profiled_kernel_ms(fn) -> float:
    """Summed device time (kernels and copies) of one call of fn under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def device_bound(tap: ProgramTap, cells: int, cycle_signal_s: float,
                 verbose: bool = True) -> dict:
    """The device-bound capacity from the newest cycle ``tap`` recorded:
    its demod + stats programs, and the MIB decode at the observed
    cadence (``mib_batches_per_cycle``), replayed from cloned arguments
    as CUDA graphs (``device_ms_per_cycle``), eagerly
    (``replay_ms_per_cycle_eager``) and once eagerly under torch.profiler,
    last (``profiler_kernel_ms_per_cycle``). ``replay_bits_equal`` holds
    the graph replay against the eager one and both against the tapped
    results, to the bit. The replays' kernel launches do not enter
    :data:`kernels.LAUNCHES` (which counts a path's real calls); they are
    returned as ``replay_launches``. Empty on the CPU, as when the tap
    recorded no cycle."""
    if "demod" not in tap.rec or \
            tap.rec["demod"][0].device.type != "cuda":
        return {}
    # No program writes an input in place (_stats returns the new ac_td
    # history beside the one it reads), so every replay reads the same
    # cloned arguments.
    rec = recorded_cycle(tap)
    mib_rate = tap.counts["mib"] / max(tap.counts["cycles"], 1)
    with_mib = "vit" in rec and tap.counts["mib"] > 0
    tapped = tapped_results(rec)
    saved = dict(kernels.LAUNCHES)
    try:
        eager = replay_cycle(rec)
        g_cyc, g_cyc_out, per_cyc = _capture(lambda: replay_cycle(rec),
                                             "demod and stats programs")
        graphs = [(g_cyc, g_cyc_out, "cycle")]
        if with_mib:
            eager.update(replay_mib(rec))
            g_vit, g_vit_out, per_vit = _capture(lambda: replay_mib(rec),
                                                 "MIB decode")
            graphs.append((g_vit, g_vit_out, "mib"))
        replays = {"cycle": 0, "mib": 0}

        def graph_run(g, key):
            def run(n):
                for _ in range(n):
                    g.replay()
                replays[key] += n
            return run

        graph_out = {}
        for g, out, key in graphs:
            graph_run(g, key)(1)
            graph_out.update(out)
        torch.cuda.synchronize()
        equal = {"eager_vs_tapped": same_bits(eager, tapped),
                 "graph_vs_eager": same_bits(graph_out, eager),
                 "graph_vs_tapped": same_bits(graph_out, tapped)}

        def eager_run(fn):
            def run(n):
                for _ in range(n):
                    fn(rec)
            return run

        graph_ms = _slope_ms(graph_run(g_cyc, "cycle"))
        eager_ms = _slope_ms(eager_run(replay_cycle))
        if with_mib:
            graph_ms += _slope_ms(graph_run(g_vit, "mib")) * mib_rate
            eager_ms += _slope_ms(eager_run(replay_mib)) * mib_rate
        # Last: a profiled run slows the launches after it.
        prof_ms = _profiled_kernel_ms(lambda: replay_cycle(rec))
        if with_mib:
            prof_ms += _profiled_kernel_ms(lambda: replay_mib(rec)) \
                * mib_rate
    finally:
        eager_launches = {k: n - saved[k] for k, n in kernels.LAUNCHES.items()
                          if n != saved[k]}
        kernels.LAUNCHES.update(saved)
    # Each replay of a graph launches the kernels its capture recorded;
    # the captures' own wrapper calls launched nothing.
    captured = [(per_cyc, replays["cycle"])]
    if with_mib:
        captured.append((per_vit, replays["mib"]))
    graph_launches = {}
    for per, n_rep in captured:
        for k, n in per.items():
            graph_launches[k] = graph_launches.get(k, 0) + n * n_rep
            eager_launches[k] -= n
    cells_dev = cells * cycle_signal_s / (graph_ms / 1e3)
    out = {
        "device_ms_per_cycle": graph_ms,
        "cells_realtime_device": cells_dev,
        "vs_baseline_device": cells_dev / BASELINE_CELLS,
        "replay_ms_per_cycle_eager": eager_ms,
        "profiler_kernel_ms_per_cycle": prof_ms,
        "mib_batches_per_cycle": mib_rate,
        "replay_bits_equal": equal,
        "replay_launches": {"graph": graph_launches,
                            "eager": eager_launches},
    }
    if verbose:
        print(f"# device bound: {graph_ms:.4f} ms per cycle in CUDA graphs "
              f"({cells_dev:.1f} cells in realtime), eager replay "
              f"{eager_ms:.4f} ms, profiler kernels {prof_ms:.4f} ms; "
              f"{mib_rate:.3f} MIB batches per cycle; bits equal {equal}",
              flush=True)
        print("# replay launches (not in kernels.LAUNCHES): graph "
              + ", ".join(f"{k} {n}" for k, n in graph_launches.items())
              + "; eager "
              + ", ".join(f"{k} {n}" for k, n in eager_launches.items()),
              flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=96)
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--chunk-ms", type=float, default=300.0,
                    help="signal per engine cycle (dispatch cadence)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = measure(args.cells, args.seconds, args.chunk_ms,
                  device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
