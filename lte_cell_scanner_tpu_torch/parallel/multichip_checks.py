"""Multi-device checks of the sharded scan and the sweeps.

Counterpart of lte_cell_scanner_tpu/parallel/multichip_checks.py and of
the JAX package's ``__graft_entry__.dryrun_multichip``: the (seq, hyp)
scan at production shape held to the unsharded scan, the cap-axis
sweep and the pipelined sweep on an N-shard mesh held to the one-shard
run, and one tracker engine cycle with its cell axis split over N shards
held to the one-device run. Devices may repeat (``("cpu",) * 4``, ``("cuda:0",) * 4``), so that
the checks run on one host or one card with the work really split.

Tolerances:
- On CPU shards the scan runs in float64 and holds at atol 1e-12 on
  every table (frq exact) against :func:`float64_scan`.
- On CUDA shards it runs in float32 (the scan kernel K1 is float32) and
  holds against the unsharded K1 scan (``xcorr_core``) at SCAN_RTOL x
  the table's maximum, the sums being taken in another order (per-shard
  fold means times their counts); frq is exact except where the two
  hypotheses' smoothed powers lie within that tolerance of each other.
- A sweep's decoded IDs, CP, n_rb_dl, ports, SFN and PHICH are exact;
  freq_superfine within 0.5 Hz (the JAX package's tests/test_sharding.py
  allows the same), and the checks report whether every field was
  bit-equal.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

SCAN_RTOL = 1e-5
DECODED = ("n_id_2", "n_id_1", "cp_type", "n_rb_dl", "n_ports", "sfn",
           "phich_duration", "phich_resource")


def planted_capture(n_cap: int, n_f: int):
    """Deterministic scan input: PSS planted in noise (the generator of
    the JAX package's dryruns, so that both scan the same capture).
    Returns (capture, hypothesis grid of n_f at 5 kHz, carrier)."""
    from lte_cell_scanner_tpu_torch.models.pss import pss_td

    rng = np.random.default_rng(0)
    cap = (rng.standard_normal(n_cap) + 1j * rng.standard_normal(n_cap)) * 0.1
    tpl = pss_td(1)
    for k in range(300, n_cap - 137, 9600):
        cap[k:k + 137] += 0.5 * tpl
    fset = (np.arange(n_f) - n_f // 2) * 5e3
    return cap, fset, 739e6


def float64_scan(capbuf, f_search_set, ds_comb_arm, fc_requested,
                 fc_programmed, fs_programmed):
    """The port's unsharded float64 scan on the host: K1's plain version
    (``xcorr_fold_plain``) and ``_collapse`` on float64 CPU tensors, from
    the float64 templates. Returns an XcorrResult."""
    import torch

    from lte_cell_scanner_tpu_torch.constants import PSS_TD_LEN
    from lte_cell_scanner_tpu_torch.ops.xcorr import (XcorrResult,
                                                      fold_start_indices,
                                                      n_comb_sp_for,
                                                      n_comb_xc_for,
                                                      shifted_templates)
    from lte_cell_scanner_tpu_torch.ops.xcorr_torch import (
        _collapse, xcorr_fold_plain)

    capbuf = np.asarray(capbuf, dtype=np.complex128)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    n_cap, n_f = len(capbuf), len(f_search_set)
    n_comb_xc = n_comb_xc_for(n_cap - (PSS_TD_LEN - 1), f_search_set,
                              fc_requested, fc_programmed, fs_programmed)
    n_comb_sp = n_comb_sp_for(n_cap)
    tpl = shifted_templates(f_search_set, fc_requested, fc_programmed,
                            fs_programmed)
    starts = fold_start_indices(f_search_set, n_comb_xc, fc_requested,
                                fc_programmed, fs_programmed)
    cap2 = torch.from_numpy(np.stack([capbuf.real, capbuf.imag]))
    fold = xcorr_fold_plain(cap2, torch.from_numpy(
        np.stack([tpl.real, tpl.imag], axis=2)), torch.from_numpy(starts),
        n_comb_xc)
    single = fold.view(n_f, 3, -1).permute(1, 2, 0)
    packed, inc = _collapse(single, cap2, ds_comb_arm, n_comb_sp)
    return XcorrResult(
        xc_incoherent_collapsed_pow=packed[0:3].numpy(),
        xc_incoherent_collapsed_frq=packed[3:6].numpy().astype(np.int64),
        xc_incoherent_single=single.numpy(),
        xc_incoherent=inc.numpy(),
        sp_incoherent=packed[6].numpy(),
        n_comb_xc=int(n_comb_xc), n_comb_sp=int(n_comb_sp))


def k1_scan(capbuf, f_search_set, ds_comb_arm, fc_requested,
            fc_programmed, fs_programmed, device):
    """The unsharded float32 scan of one capture on ``device`` (K1 on the
    card: ``xcorr_core``), its tables copied to the host as an
    XcorrResult."""
    import torch

    from lte_cell_scanner_tpu_torch.ops.xcorr import XcorrResult
    from lte_cell_scanner_tpu_torch.ops.xcorr_torch import (scan_plan,
                                                            xcorr_core)

    capbuf = np.asarray(capbuf)
    plan = scan_plan(len(capbuf), f_search_set, fc_requested, fc_programmed,
                     fs_programmed)
    cap2 = torch.from_numpy(np.stack([capbuf.real, capbuf.imag]).astype(
        np.float32)).to(device)
    packed, single, inc = xcorr_core(cap2, plan, ds_comb_arm)

    def host(t):
        return t.cpu().numpy().astype(np.float64)

    return XcorrResult(host(packed[0:3]),
                       packed[3:6].cpu().numpy().astype(np.int64),
                       host(single), host(inc), host(packed[6]),
                       plan.n_comb_xc, plan.n_comb_sp)


def assert_scan_parity(out, ref, atol: float = 1e-12) -> None:
    """Every table of two scans within ``atol``, frq and counts exact."""
    for name in ("xc_incoherent_collapsed_pow", "xc_incoherent_single",
                 "xc_incoherent", "sp_incoherent"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(out.xc_incoherent_collapsed_frq,
                                  ref.xc_incoherent_collapsed_frq)
    assert (out.n_comb_xc, out.n_comb_sp) == (ref.n_comb_xc, ref.n_comb_sp)


def scan_close(out, ref, rtol: float = SCAN_RTOL) -> float:
    """Two float32 scans within ``rtol`` x each table's maximum; frq
    equal except at near ties. Returns the largest error relative to its
    table's maximum; raises AssertionError beyond the tolerance."""
    worst = 0.0
    for name in ("xc_incoherent_collapsed_pow", "xc_incoherent_single",
                 "xc_incoherent", "sp_incoherent"):
        g, w = getattr(out, name), getattr(ref, name)
        err = float(np.abs(g - w).max() / np.abs(w).max())
        assert err <= rtol, f"{name}: {err:.3e} x max (want <= {rtol:g})"
        worst = max(worst, err)
    inc = ref.xc_incoherent
    fg, fw = out.xc_incoherent_collapsed_frq, ref.xc_incoherent_collapsed_frq
    r, lag = np.nonzero(fg != fw)
    gap = np.abs(inc[r, lag, fg[r, lag]] - inc[r, lag, fw[r, lag]])
    assert (gap <= rtol * np.abs(inc).max()).all(), \
        f"frq differs at {len(r)} lags beyond a near tie"
    assert (out.n_comb_xc, out.n_comb_sp) == (ref.n_comb_xc, ref.n_comb_sp)
    return worst


def same_cells(got, want) -> bool:
    """Each capture's cells: decoded fields exact, freq_superfine within
    0.5 Hz (AssertionError otherwise). Returns whether every field of
    every cell was bit-equal."""
    assert len(got) == len(want), "capture count"
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"capture {b}: cell count"
        for cg, cw in zip(g, w):
            assert [getattr(cg, f) for f in DECODED] == \
                [getattr(cw, f) for f in DECODED], f"capture {b}: cell"
            assert abs(cg.freq_superfine - cw.freq_superfine) < 0.5, \
                f"capture {b}: freq_superfine"
    return all(dataclasses.asdict(cg) == dataclasses.asdict(cw)
               for g, w in zip(got, want) for cg, cw in zip(g, w))


def check_pipelined_sweep_multidevice(n_devices: int, n_sweep: int = None,
                                      devices=None,
                                      verbose: bool = False) -> dict:
    """Run the pipelined fc sweep on an ``n_devices``-shard cap mesh (the
    first CUDA cards, or ``devices``, which may repeat) and hold its
    decoded cells to the one-shard run of the same sweep
    (:func:`same_cells`). Returns {"cells": decoded cells compared,
    "bit_equal": every field of every cell bit-equal}."""
    from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
    from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (CapMesh,
                                                              make_cap_mesh)
    from lte_cell_scanner_tpu_torch.search.pipeline import \
        pipelined_search_sweep
    from lte_cell_scanner_tpu_torch.tools.profile_pipeline import \
        radio_planes

    mesh = (make_cap_mesh(n_devices) if devices is None
            else CapMesh(devices))
    if len(mesh.devices) != n_devices:
        raise ValueError(f"{len(mesh.devices)} devices for {n_devices} "
                         "shards")
    if n_sweep is None:
        # The smallest multiple of n_devices >= 8.
        n_sweep = max(8, -(-8 // n_devices) * n_devices)
    if n_sweep % n_devices:
        raise ValueError("n_sweep must divide over the mesh")
    # Two distinct planted cells alternating across the sweep, offsets
    # inside a small 5-hypothesis grid (decode load on every capture).
    cap_a = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                              freq_offset=4e3, seed=5)
    cap_b = synthetic_capture(n_id_1=30, n_id_2=0, snr_db=15,
                              freq_offset=-6e3, n_rb_dl=75, seed=7)
    planes = [radio_planes(c, 1.0) for c in (cap_a, cap_b[:len(cap_a)])]
    caps = np.stack([planes[i % 2] for i in range(n_sweep)])
    fcs = [739e6 + 100e3 * i for i in range(n_sweep)]
    fset = np.arange(-2, 3) * 5e3

    def run(m):
        per_cap, _ = pipelined_search_sweep(caps, fcs, fset, m,
                                            batch=n_sweep,
                                            dedup_cells=False)
        return per_cap

    want = run(CapMesh(mesh.devices[:1]))
    got = run(mesh)
    n_cells = sum(len(p) for p in want)
    if n_cells < n_sweep:
        raise AssertionError(f"sweep under-decoded: {n_cells} cells")
    bit_equal = same_cells(got, want)
    if verbose:
        print(f"pipelined sweep multidevice OK: {n_sweep} captures on a "
              f"cap={n_devices} mesh, {n_cells} cells equal to one shard's "
              f"(bit-equal: {bit_equal})")
    return {"cells": n_cells, "bit_equal": bit_equal}


# ----------------------------------------------------------------------
# The tracker's cell axis (counterpart of the JAX check_tracker_cells_sharded).

TRACKER_DEMOD = ("kept", "sync_tp", "sync_sp", "sync_np", "sync_np_blank",
                 "sync_ce")
TRACKER_STATS = ("foe_ang", "foe_np", "delay", "delay_np", "ce_filt", "scal",
                 "ac_sum", "acw_sum", "carry_out", "td_xc")
# Lanes that the feedback loops read, held exact; the other stats lanes are
# diagnostics, held to the JAX check's bound (rtol 2e-2, atol 2e-3, >= 99%
# of the stats payload exact).
TRACKER_EXACT = ("foe_ang", "foe_np", "delay", "delay_np")


@functools.lru_cache(maxsize=2)
def _tracker_harvest(device: str):
    """tools/bench_tracker's harvest on ``device``: the descriptor PDUs of
    one tracked simulated cell over ~0.4 s of signal and the raw blocks
    they index (cached: a check per shard count reuses it)."""
    from lte_cell_scanner_tpu_torch.tools.bench_tracker import _collect_pdus

    return _collect_pdus(0.4, torch.device(device))


def tracker_cycle(cells: int, device, cycle_ms: float = 20.0):
    """One real engine cycle of ``cells`` replicas of a tracked simulated
    cell (distinct serials, never dropped) fed ``cycle_ms`` of harvested
    PDUs each, on ``device``. Returns the arguments the engine passed to
    its two device programs, (demod_args, stats_args), tapped as the JAX
    check taps its jitted programs."""
    import lte_cell_scanner_tpu_torch.tracker.batch_runtime as br
    from lte_cell_scanner_tpu_torch.tracker.state import (GlobalState,
                                                          TrackedCell)

    dev = torch.device(device)
    pdus, raw_blocks, proto = _tracker_harvest(str(dev))
    n_feed = int(cycle_ms / 1000 * proto.n_symb_dl * 2000)
    if len(pdus) < n_feed:
        raise RuntimeError(f"tracker_cycle: {len(pdus)} PDUs harvested, "
                           f"{n_feed} asked for")
    state = GlobalState(fc_requested=739e6, fc_programmed=739e6,
                        fs_programmed=1.92e6, frequency_offset=4000.0)
    cs = [TrackedCell(
        n_id_cell=proto.n_id_cell, n_ports=proto.n_ports,
        cp_type=proto.cp_type, n_rb_dl=proto.n_rb_dl,
        phich_duration=proto.phich_duration,
        phich_resource=proto.phich_resource,
        frame_timing=proto.frame_timing, serial_num=m,
        drop_threshold=float("inf")) for m in range(cells)]
    engine = br.BatchTrackerEngine(state, device=dev)
    for blk in raw_blocks:
        engine.push_raw(blk)
    for c in cs:
        c.fifo.extend(pdus[:n_feed])
    rec = {}
    orig = br._demod_stream, br._stats

    def tap_demod(*a):
        rec["demod"] = a
        return orig[0](*a)

    def tap_stats(*a):
        rec["stats"] = a
        return orig[1](*a)

    br._demod_stream, br._stats = tap_demod, tap_stats
    try:
        engine.process_all(cs)
    finally:
        br._demod_stream, br._stats = orig
    if "demod" not in rec or "stats" not in rec:
        raise RuntimeError("tracker_cycle: the engine cycle never ran")
    return rec["demod"], rec["stats"]


def _rebase_rows(g: np.ndarray, a: int, b: int, C: int, R: int, P: int):
    """Row indices of the stats program's combined row space (the carry
    block (C, P, 2), then the cycle's CE rows (C, R, P)) as the shard of
    cells [a, b) numbers them. Returns (local, owned): an index of another
    shard's cell must be the engine's placeholder 0 and becomes local 0,
    not owned."""
    n_car = C * P * 2
    carry = g < n_car
    cell = np.where(carry, g // (2 * P), (g - n_car) // (R * P))
    owned = (cell >= a) & (cell < b)
    if not (owned | (g == 0)).all():
        raise AssertionError("a row index crosses shards")
    local = np.where(carry, g - a * 2 * P,
                     (b - a) * 2 * P + (g - n_car) - a * R * P)
    return np.where(owned, local, 0), owned


def split_tracker_cycle(demod_args, stats_args, devices) -> list:
    """Cut one engine cycle's program arguments by cell into
    ``len(devices)`` shards of consecutive cells (sizes differing by at
    most one, so any shard count divides any cell count), shard k on
    ``devices[k]``. The raw stream segment is replicated; every per-cell
    array is cut; every index into the stats program's combined row space
    (``tri``, ``carry_idx``, ``td_rows``, ``td0_rows``), the segment ids,
    the emit rows and ``td0_sp`` (triple numbers) are rebased to the
    shard. A shard's triples are a contiguous run: segments are ordered
    by cell. Returns one dict per shard."""
    np_ = {k: v.cpu().numpy() for k, v in zip(
        ("tri", "pl", "seg_id", "emit", "carry_idx", "td_rows", "td_new",
         "td0_rows", "td0_new", "td0_sp"), stats_args[2:12])}
    ce_dev = stats_args[0]
    C, R, P = ce_dev.shape[:3]
    seg_id = np_["seg_id"]
    if (np.diff(seg_id) < 0).any() or seg_id[0] >= C:
        raise AssertionError("cycle without ordered triples")
    k72 = np.arange(72)[None, :]
    bounds = np.cumsum([0] + [len(x) for x in np.array_split(
        np.arange(C), len(devices))])
    shards = []
    for dev, a, b in zip(devices, bounds[:-1], bounds[1:]):
        a, b = int(a), int(b)
        Cs, dev = b - a, torch.device(dev)
        ta, tb = (int(x) for x in np.searchsorted(seg_id, [a, b]))

        def put(x, dev=dev):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(dev)

        demod = (put(demod_args[0]),) + tuple(
            put(x[a:b]) for x in demod_args[1:])
        tri, tri_own = _rebase_rows(np_["tri"][ta:tb], a, b, C, R, P)
        if not tri_own.all():
            raise AssertionError("a triple reads another shard's rows")
        pl, seg = np_["pl"][ta:tb], np_["seg_id"][ta:tb] - a
        if tb == ta:                   # no triple: the engine's padding
            tri, pl = np.zeros((1, 3), np.int64), np.zeros(1, bool)
            seg = np.full(1, Cs, np.int64)
        emit = np_["emit"]
        emit_pos = np.nonzero((emit >= ta) & (emit < tb))[0]
        emit_s = emit[emit_pos] - ta if len(emit_pos) else np.zeros(1,
                                                                    np.int64)
        carry_idx, carry_own = _rebase_rows(np_["carry_idx"][a:b], a, b, C,
                                            R, P)
        rows = slice(a * P, b * P)
        td = {}
        for name, new in (("td_rows", "td_new"), ("td0_rows", "td0_new")):
            used = k72 >= 72 - np_[new][rows][:, None]
            loc, own = _rebase_rows(np_[name][rows], a, b, C, R, P)
            if not own[used].all():
                raise AssertionError(f"{name} reads another shard's rows")
            td[name] = np.where(used, loc, 0)
        sp = np_["td0_sp"][rows]
        td_own = (sp >= ta) & (sp < tb)
        if not (td_own | (sp == 0)).all():
            raise AssertionError("td0_sp names another shard's triple")
        stats = tuple(put(x) for x in (
            stats_args[1][a:b], tri, pl, seg, emit_s, carry_idx,
            td["td_rows"], np_["td_new"][rows], td["td0_rows"],
            np_["td0_new"][rows], np.where(td_own, sp - ta, 0),
            stats_args[12][rows]))
        shards.append(dict(cells=(a, b), device=dev, demod=demod,
                           stats=stats, n_seg=Cs + 1, triples=(ta, tb),
                           emit_pos=emit_pos, carry_owned=carry_own,
                           td_owned=td_own))
    return shards


def run_tracker_shards(shards) -> list:
    """Every shard's demod program (the K4 stream kernel once per shard on
    the card), then every shard's stats program on its own demod's CE
    rows. Returns per shard [demod flat, CE rows, stats flat, td_hist]."""
    import lte_cell_scanner_tpu_torch.tracker.batch_runtime as br

    outs = [list(br._demod_stream(*sh["demod"])) for sh in shards]
    for sh, o in zip(shards, outs):
        o.extend(br._stats(o[1], *sh["stats"], sh["n_seg"]))
    return outs


def _merge_tracker_shards(shards, outs, C, P, Q, K, T, E):
    """The shards' results unpacked and placed at their global rows:
    ({field: array}, {field: mask of the entries placed})."""
    import lte_cell_scanner_tpu_torch.tracker.batch_runtime as br

    got, mask = {}, {}

    def place(field, where, value, shape, m=True):
        if field not in got:
            got[field] = np.full(shape, np.nan)
            mask[field] = np.zeros(shape, bool)
        got[field][where] = value
        mask[field][where] = m

    d_shapes = dict(zip(TRACKER_DEMOD, br.demod_shapes(C, Q, K)))
    s_shapes = dict(zip(TRACKER_STATS, (
        sh[1] if sh[0] == "f32" else sh
        for sh in br.stats_shapes(T, E, C, P))))
    # The AC sums' pad segment (row C) is never read.
    s_shapes["ac_sum"], s_shapes["acw_sum"] = (C, 12, 2), (C, 12)
    for sh, (flat, ce, flat2, hist) in zip(shards, outs):
        a, b = sh["cells"]
        Cs, (ta, tb), pos = b - a, sh["triples"], sh["emit_pos"]
        Ts, Es = max(1, tb - ta), max(1, len(pos))
        for f, v in zip(TRACKER_DEMOD, br._unpack(
                flat.cpu().numpy(), br.demod_shapes(Cs, Q, K))):
            place(f, slice(a, b), v, d_shapes[f])
        place("ce", slice(a, b), ce.cpu().numpy(), (C,) + tuple(ce.shape[1:]))
        place("td_hist", slice(a * P, b * P), hist.cpu().numpy(),
              (C * P,) + tuple(hist.shape[1:]))
        s = dict(zip(TRACKER_STATS, br._unpack(
            flat2.cpu().numpy(), br.stats_shapes(Ts, Es, Cs, P))))
        for f in TRACKER_EXACT:
            place(f, slice(ta, tb), s[f][:tb - ta], s_shapes[f])
        for f in ("ce_filt", "scal"):
            place(f, pos, s[f][:len(pos)], s_shapes[f])
        for f in ("ac_sum", "acw_sum"):
            place(f, slice(a, b), s[f][:Cs], s_shapes[f])
        place("carry_out", slice(a, b), s["carry_out"], s_shapes["carry_out"],
              sh["carry_owned"][..., None, None])
        place("td_xc", slice(a * P, b * P), s["td_xc"], s_shapes["td_xc"],
              sh["td_owned"][:, None, None])
    return got, mask


def check_tracker_cells_sharded(n_devices: int, cells: int = None,
                                devices=None, verbose: bool = False,
                                cycle_ms: float = 20.0) -> dict:
    """Run one REAL engine cycle's demod and stats programs with the cell
    axis split over ``n_devices`` shards (the first CUDA cards, or
    ``devices``, which may repeat) and hold them to the one-device run on
    the first device. The cycle's arguments are harvested from a live
    engine run of ``cells`` replicas (default 2 per shard) fed
    ``cycle_ms`` of signal each (:func:`tracker_cycle`); shards may differ
    in size by one cell (:func:`split_tracker_cycle`). The results are
    compared unpacked, field by field, each shard's rows at their global
    rows: the demod outputs, the raw CE rows, the new ac_td history and
    the FOE/TOE lanes exact; the diagnostic lanes (filtered CE, scalars,
    AC sums, carry rows, ac_td correlations) within rtol 2e-2 and atol
    2e-3 with >= 99% of the stats payload exact (the JAX check's bound).
    Entries that the engine fills with a placeholder (a carry slot or an
    ac_td row without data) are not compared: the host never reads them.
    Returns {"cells", "shards" (sizes), "triples", "launches" (the split
    run's kernel launches), "fields" ({field: (compared, exact, max abs
    err)}), "bit_equal"}; raises AssertionError on a failed check."""
    import lte_cell_scanner_tpu_torch.tracker.batch_runtime as br
    from lte_cell_scanner_tpu_torch.kernels import LAUNCHES
    from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (CapMesh,
                                                              make_cap_mesh)

    devs = (make_cap_mesh(n_devices) if devices is None
            else CapMesh(devices)).devices
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices for {n_devices} shards")
    cells = 2 * n_devices if cells is None else cells
    da, sa = tracker_cycle(cells, devs[0], cycle_ms)
    C, Q, K = da[10].shape[0], da[10].shape[1], da[11].shape[1]
    T, E, P = sa[2].shape[0], sa[5].shape[0], sa[0].shape[2]

    flat, ce = br._demod_stream(*da)
    flat2, hist = br._stats(ce, *sa[1:])
    want = dict(zip(TRACKER_DEMOD, br._unpack(flat.cpu().numpy(),
                                              br.demod_shapes(C, Q, K))))
    want.update(zip(TRACKER_STATS, br._unpack(
        flat2.cpu().numpy(), br.stats_shapes(T, E, C, P))))
    want.update(ce=ce.cpu().numpy(), td_hist=hist.cpu().numpy(),
                ac_sum=want["ac_sum"][:C], acw_sum=want["acw_sum"][:C])

    shards = split_tracker_cycle(da, sa, devs)
    before = dict(LAUNCHES)
    outs = run_tracker_shards(shards)
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    got, mask = _merge_tracker_shards(shards, outs, C, P, Q, K, T, E)

    fields = {}
    for f, m in mask.items():
        if f not in ("carry_out", "td_xc") and not m.all():
            raise AssertionError(f"{f}: the shards leave entries unfilled")
        g, w = got[f][m], want[f][m]
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        err = np.abs(g - w)
        fields[f] = (int(m.sum()), int(same.sum()),
                     float(np.nanmax(err, initial=0.0)))
    for f, (n, n_eq, err) in fields.items():
        if f in TRACKER_STATS and f not in TRACKER_EXACT:
            np.testing.assert_allclose(got[f][mask[f]], want[f][mask[f]],
                                       rtol=2e-2, atol=2e-3, equal_nan=True,
                                       err_msg=f)
        elif n_eq != n:
            raise AssertionError(f"{f}: {n - n_eq} of {n} entries differ "
                                 f"(max abs err {err:.3e}), want bit-equal")
    n_st = sum(fields[f][0] for f in TRACKER_STATS)
    exact = sum(fields[f][1] for f in TRACKER_STATS) / n_st
    if exact < 0.99:
        raise AssertionError(f"stats payload exact fraction {exact:.4f}")
    sizes = [sh["cells"][1] - sh["cells"][0] for sh in shards]
    bit_equal = all(n == n_eq for n, n_eq, _ in fields.values())
    if verbose:
        print(f"tracker cells split OK: {C} cells x {cycle_ms:g} ms in "
              f"shards of {sizes} on {[str(d) for d in devs]}, {T} triples; "
              f"demod, CE rows, ac_td history and FOE/TOE bit-equal; stats "
              f"payload {100 * exact:.3f}% exact (every field bit-equal: "
              f"{bit_equal})")
    return {"cells": C, "shards": sizes, "triples": int(T),
            "launches": launches, "fields": fields, "bit_equal": bit_equal}


def dryrun_multichip(n_devices: int, devices=None,
                     n_cap: int = 153600) -> dict:
    """The sharded scan at PRODUCTION shape (by default the 153,600-sample
    capture, ``n_cap`` samples, x the 31 hypotheses of a ppm=100 grid,
    padded to a multiple of n_hyp)
    on an n_devices (seq, hyp) mesh, held to the unsharded scan (float64
    on CPU shards at 1e-12, float32 on CUDA shards at SCAN_RTOL: see the
    module docstring); then the cap-axis sweep on n_devices shards,
    :func:`check_pipelined_sweep_multidevice` and
    :func:`check_tracker_cells_sharded`. ``devices``: the shards'
    devices (default: the first CUDA cards); they may repeat. Returns a
    summary dict; raises AssertionError on a failed check."""
    from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (
        CapMesh, sharded_fc_sweep)
    from lte_cell_scanner_tpu_torch.parallel.sharded_search import (
        make_search_mesh, sharded_xcorr_pss)

    n_hyp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_seq = n_devices // n_hyp
    mesh = make_search_mesh(n_seq, n_hyp, devices=devices)
    devs = mesh.devices
    on_cpu = devs[0].type == "cpu"
    n_f = 31 + (-31 % n_hyp)  # ppm=100 grid, padded to divide over hyp
    cap, fset, fc = planted_capture(n_cap, n_f)
    out = sharded_xcorr_pss(cap, fset, 2, fc, fc, 1.92e6, mesh,
                            dtype=np.float64 if on_cpu else np.float32)
    if on_cpu:
        assert_scan_parity(out, float64_scan(cap, fset, 2, fc, fc, 1.92e6))
        err = 0.0
    else:
        err = scan_close(out, k1_scan(cap, fset, 2, fc, fc, 1.92e6,
                                      devs[0]))
    pss, lag = np.unravel_index(np.argmax(out.xc_incoherent_collapsed_pow),
                                (3, 9600))

    # The cap axis: n_devices captures on n_devices shards against one
    # shard (small shapes; the production-shape check is above).
    cap_s, fset_s, fc_s = planted_capture(48000, 4)
    caps = np.stack([cap_s] * n_devices)
    fcs = [fc_s + i * 100e3 for i in range(n_devices)]
    peaks = sharded_fc_sweep(caps, fcs, fset_s, CapMesh(devs))
    one = sharded_fc_sweep(caps, fcs, fset_s, CapMesh(devs[:1]))
    assert all(len(p) >= 1 and p[0].n_id_2 == pss for p in peaks), \
        "cap-axis sweep missed the cell"
    assert [[(c.n_id_2, c.ind, c.freq) for c in p] for p in peaks] == \
        [[(c.n_id_2, c.ind, c.freq) for c in p] for p in one], \
        "cap-axis sweep: peaks differ from one shard's"
    pipe = check_pipelined_sweep_multidevice(n_devices, devices=devs)
    trk = check_tracker_cells_sharded(n_devices, devices=devs)
    res = {"seq": n_seq, "hyp": n_hyp, "n_f": n_f, "scan_err": err,
           "peak": (int(pss), int(lag)), "pipelined": pipe, "tracker": trk}
    print(f"dryrun_multichip OK: mesh seq={n_seq} x hyp={n_hyp} on "
          f"{[str(d) for d in devs]} at {n_cap}x{n_f} ("
          + ("float64, 1e-12 table parity" if on_cpu else
             f"float32, {err:.3e} x max of the unsharded K1 scan")
          + f"), peak at pss={pss} lag={lag}; cap={n_devices} sweep equal "
          f"to one shard's; pipelined sweep {pipe['cells']} cells equal to "
          f"one shard's (bit-equal: {pipe['bit_equal']}); tracker cycle "
          f"({trk['cells']} cells in shards of {trk['shards']}) equal to "
          f"one device's (bit-equal: {trk['bit_equal']})")
    return res
