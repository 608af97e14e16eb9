"""Multi-device checks of the sharded scan and the sweeps.

Counterpart of lte_cell_scanner_tpu/parallel/multichip_checks.py and of
the JAX package's ``__graft_entry__.dryrun_multichip``: the (seq, hyp)
scan at production shape held to the unsharded scan, the cap-axis
sweep, and the pipelined sweep on an N-shard mesh held to the one-shard
run. Devices may repeat (``("cpu",) * 4``, ``("cuda:0",) * 4``), so that
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

import numpy as np

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


def dryrun_multichip(n_devices: int, devices=None,
                     n_cap: int = 153600) -> dict:
    """The sharded scan at PRODUCTION shape (by default the 153,600-sample
    capture, ``n_cap`` samples, x the 31 hypotheses of a ppm=100 grid,
    padded to a multiple of n_hyp)
    on an n_devices (seq, hyp) mesh, held to the unsharded scan (float64
    on CPU shards at 1e-12, float32 on CUDA shards at SCAN_RTOL: see the
    module docstring); then the cap-axis sweep on n_devices shards and
    :func:`check_pipelined_sweep_multidevice`. ``devices``: the shards'
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
    res = {"seq": n_seq, "hyp": n_hyp, "n_f": n_f, "scan_err": err,
           "peak": (int(pss), int(lag)), "pipelined": pipe}
    print(f"dryrun_multichip OK: mesh seq={n_seq} x hyp={n_hyp} on "
          f"{[str(d) for d in devs]} at {n_cap}x{n_f} ("
          + ("float64, 1e-12 table parity" if on_cpu else
             f"float32, {err:.3e} x max of the unsharded K1 scan")
          + f"), peak at pss={pss} lag={lag}; cap={n_devices} sweep equal "
          f"to one shard's; pipelined sweep {pipe['cells']} cells equal to "
          f"one shard's (bit-equal: {pipe['bit_equal']})")
    return res
