"""Multi-process runs of the sharded PSS scan and the fc sweep on
``torch.distributed``.

Counterpart of lte_cell_scanner_tpu/parallel/multihost.py, whose
``jax.distributed`` session becomes a ``torch.distributed`` process group
(NCCL between cards, gloo between CPU processes):

- :func:`init_multihost`: join this process to the run's process group.
- The (seq, hyp) search mesh of parallel/sharded_search.py spans every
  process once the group is up; each process stages only its own capture
  blocks and templates, and the ``all_reduce`` of the partial fold tables
  and the ``all_gather`` of the hypothesis slices are the only traffic
  between processes.
- :func:`dryrun_multihost`: spawns N worker processes (gloo over
  localhost, CPU shards), runs the production-shape scan sharded across
  the process boundary, and asserts 1e-12 full-table parity against the
  port's float64 scan in every process.
- :func:`measure_sweep_scaling`: the capture-sharded fc sweep's
  throughput at 1 and N processes. The ``cap`` axis needs no traffic
  between processes during the sweep; the only collective is the merge of
  the cell lists.

Workers are ``python -m lte_cell_scanner_tpu_torch.parallel.multihost``
processes configured by MH_* environment variables.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

_OK_MARK = "MULTIHOST_PARITY_OK"


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, device=None) -> None:
    """Join this process to the run's process group.

    ``coordinator_address`` is the host:port of rank 0's TCP store.
    ``device`` is where this process's shards live: ``None``, the CUDA
    card (raising without one), or a CUDA device, over NCCL; ``"cpu"``
    over gloo. After it returns, make_search_mesh() builds meshes that
    span every process."""
    import torch
    import torch.distributed as dist

    from lte_cell_scanner_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _join() -> int:
    """Set up a CPU worker from its MH_* environment: one torch thread,
    the gloo group. Returns its shard count."""
    import torch

    torch.set_num_threads(1)
    init_multihost(os.environ["MH_COORD"], int(os.environ["MH_NPROC"]),
                   int(os.environ["MH_PID"]), device="cpu")
    return int(os.environ["MH_DEVS"])


def _sweep_worker() -> None:
    """Capture-sharded sweep throughput worker (MH_MODE=sweep).

    Measures this process's wall-clock for ITS shard of an fc sweep
    inside a real process group. The processes take turns: process p
    computes while every other process waits in a gloo barrier (a
    blocking socket read), so that each t_self is a measurement on an
    unloaded host, and the cost of a barrier between processes is
    measured separately. The parent combines them (see
    measure_sweep_scaling).
    """
    import torch.distributed as dist

    from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (
        CapMesh, cap_shards, sharded_fc_sweep)
    from lte_cell_scanner_tpu_torch.parallel.multichip_checks import \
        planted_capture

    n_dev = _join()
    try:
        n_procs = dist.get_world_size()
        pid = dist.get_rank()
        n_cap = int(os.environ.get("MH_NCAP", "153600"))
        n_f = int(os.environ.get("MH_NF", "4"))
        b_local = int(os.environ.get("MH_B", "4"))
        reps = int(os.environ.get("MH_REPS", "2"))

        cap, fset, fc = planted_capture(n_cap, n_f)
        caps = np.stack([cap] * b_local)
        fcs = [fc + 100e3 * (pid * b_local + i) for i in range(b_local)]
        # A LOCAL mesh: the capture axis needs no traffic between
        # processes, so each sweeps its captures on its own shards.
        mesh = CapMesh(["cpu"] * cap_shards(b_local, n_dev))

        def sweep_once():
            return sharded_fc_sweep(caps, fcs, fset, mesh)

        peaks = sweep_once()                          # warm-up
        # The merge of the cell lists: the one collective of the sweep.
        merged = [None] * n_procs
        dist.all_gather_object(merged, [[c.n_id_2 for c in p]
                                        for p in peaks])
        if not all(len(p) >= 1 for m in merged for p in m):
            raise RuntimeError(f"planted PSS not found: {merged}")
        dist.barrier()
        t_self = 0.0
        for slot in range(n_procs):
            dist.barrier()
            if slot == pid:
                t0 = time.time()
                for _ in range(reps):
                    sweep_once()
                t_self = time.time() - t0
        dist.barrier()
        t0 = time.time()
        for _ in range(8):
            dist.barrier()
        t_comm = (time.time() - t0) / 8
        print(f"MULTIHOST_SWEEP proc={pid}/{n_procs} t_self={t_self:.3f} "
              f"t_comm={t_comm:.4f} samples={reps * b_local * n_cap}",
              flush=True)
    finally:
        dist.destroy_process_group()


def _worker_main() -> None:
    """Entry point of each worker process (configured via MH_* env)."""
    if os.environ.get("MH_MODE") == "sweep":
        _sweep_worker()
        return
    import torch.distributed as dist

    from lte_cell_scanner_tpu_torch.parallel.multichip_checks import (
        assert_scan_parity, float64_scan, planted_capture)
    from lte_cell_scanner_tpu_torch.parallel.sharded_search import (
        make_search_mesh, sharded_xcorr_pss)

    n_dev = _join()
    try:
        n_cap = int(os.environ.get("MH_NCAP", "153600"))
        n_f = int(os.environ.get("MH_NF", "8"))
        n_seq = int(os.environ["MH_SEQ"])
        n_hyp = int(os.environ["MH_HYP"])
        if dist.get_world_size() != int(os.environ["MH_NPROC"]):
            raise RuntimeError("process group of the wrong size")
        mesh = make_search_mesh(n_seq, n_hyp, devices=["cpu"] * n_dev)
        cap, fset, fc = planted_capture(n_cap, n_f)

        t0 = time.time()
        out = sharded_xcorr_pss(cap, fset, 2, fc, fc, 1.92e6, mesh,
                                dtype=np.float64)
        t_dist = time.time() - t0
        assert_scan_parity(out, float64_scan(cap, fset, 2, fc, fc, 1.92e6))
        print(f"{_OK_MARK} proc={dist.get_rank()}/{dist.get_world_size()} "
              f"mesh=seq{n_seq}xhyp{n_hyp} n_cap={n_cap} n_f={n_f} "
              f"dist_wallclock={t_dist:.1f}s", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multihost(n_procs: int = 2, devices_per_proc: int = 4,
                     n_cap: int = 153600, n_f: int = 8,
                     n_hyp: int = 2, timeout: float = 900.0,
                     verbose: bool = True) -> None:
    """Launch the N-process CPU parity dryrun; raises on any failure.

    Each process holds ``devices_per_proc`` CPU shards and the (seq, hyp)
    mesh spans all of them, so that the fold ``all_reduce`` crosses the
    process boundary (and the hypothesis ``all_gather`` too when a
    process holds less than a row). Each process waits at most
    ``timeout`` seconds.
    """
    n_dev = n_procs * devices_per_proc
    n_seq = n_dev // n_hyp
    # One retry: on a shared host a concurrent CPU-heavy job can starve a
    # worker past the gloo handshake deadline, which shows up as a missing
    # parity marker — a transient, not a correctness bug.
    last_detail = ""
    for attempt in range(2):
        try:
            outs = _launch_workers(n_procs, devices_per_proc,
                                   dict(MH_NCAP=n_cap, MH_NF=n_f,
                                        MH_SEQ=n_seq, MH_HYP=n_hyp),
                                   timeout)
        except RuntimeError as e:
            outs, last_detail = None, str(e)
        else:
            failures = [i for i, out in enumerate(outs)
                        if _OK_MARK not in out]
            if not failures:
                break
            last_detail = ("missing parity marker in process(es) "
                           f"{failures}:\n" + "\n---\n".join(
                               _tail(o) for o in outs))
    else:
        try:
            load = ", ".join(f"{v:.1f}" for v in os.getloadavg())
        except OSError:  # pragma: no cover - non-POSIX
            load = "unavailable"
        raise RuntimeError(
            "multihost dryrun failed twice. If the 1-min load average "
            f"({load}) exceeds the core count, CPU contention starving "
            "the gloo handshake is the likely cause — rerun on an idle "
            f"host.\n{last_detail}")
    if verbose:
        for out in outs:
            for line in out.splitlines():
                if _OK_MARK in line:
                    print(line)
        print(f"dryrun_multihost OK: {n_procs} processes x "
              f"{devices_per_proc} shards, mesh seq={n_seq} x hyp={n_hyp}, "
              "1e-12 table parity across the process boundary")


def _tail(out: str, n: int = 12) -> str:
    """Last ``n`` lines of a worker's combined output (diagnostics)."""
    return "\n".join(out.splitlines()[-n:])


def _launch_workers(n_procs: int, devices_per_proc: int, env_extra: dict,
                    timeout: float):
    """Spawn the N worker processes and collect their output; each gets
    ``timeout`` seconds of its own, then every worker is killed."""
    coord = f"127.0.0.1:{_free_port()}"
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ, MH_COORD=coord, MH_NPROC=str(n_procs),
                   MH_PID=str(pid), MH_DEVS=str(devices_per_proc),
                   **{k: str(v) for k, v in env_extra.items()})
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "lte_cell_scanner_tpu_torch.parallel.multihost"],
            env=env, cwd=repo_root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError("multihost run timed out:\n" + "\n".join(outs))
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"multihost process(es) {bad} failed:\n"
                           + "\n---\n".join(outs))
    return outs


def _measure_sweep_once(n_procs: int, b_per_proc: int,
                        devices_per_proc: int, n_f: int, n_cap: int,
                        reps: int, timeout: float) -> dict:
    """One full 1-process + N-process throughput measurement (see
    measure_sweep_scaling for the method).

    Both legs sweep the SAME per-process batch (weak scaling: samples/s
    scaling); a 1-process leg sweeping N*b captures would have an
    N-times-larger working set, whose cache behaviour would differ from
    the per-process runs."""
    env = dict(MH_MODE="sweep", MH_NCAP=n_cap, MH_NF=n_f, MH_REPS=reps,
               MH_B=b_per_proc)

    def parse(outs):
        vals = []
        for out in outs:
            for line in out.splitlines():
                if line.startswith("MULTIHOST_SWEEP"):
                    d = dict(kv.split("=") for kv in line.split()[1:])
                    vals.append((float(d["t_self"]), float(d["t_comm"]),
                                 int(d["samples"])))
        if len(vals) != len(outs):
            raise RuntimeError("missing MULTIHOST_SWEEP marker:\n"
                               + "\n---\n".join(outs))
        return vals

    outs1 = _launch_workers(1, devices_per_proc, env, timeout)
    (t1, _, samples1), = parse(outs1)
    outsn = _launch_workers(n_procs, devices_per_proc, env, timeout)
    valsn = parse(outsn)
    t_n = max(v[0] for v in valsn) + max(v[1] for v in valsn)
    samples_n = sum(v[2] for v in valsn)
    rate1 = samples1 / t1
    rate_n = samples_n / t_n
    return {
        "n_procs": n_procs,
        "captures_per_host": b_per_proc,
        "t_1host_s": round(t1, 3),
        "t_nhost_s": round(t_n, 3),
        "t_comm_s": round(max(v[1] for v in valsn), 4),
        "samples_per_sec_1host": int(rate1),
        "samples_per_sec_nhost_total": int(rate_n),
        "scaling": round(rate_n / (n_procs * rate1), 3),
    }


def measure_sweep_scaling(n_procs: int = 2, b_per_proc: int = 8,
                          devices_per_proc: int = 1, n_f: int = 4,
                          n_cap: int = 153600, reps: int = 4,
                          timeout: float = 1200.0,
                          verbose: bool = True,
                          n_meas: int = 3) -> dict:
    """MEASURE the capture-sharded fc sweep's throughput at 1 vs N
    processes on the CPU (weak scaling: both legs sweep ``b_per_proc``
    captures per process):

    - a 1-process run sweeping b_per_proc captures gives T1;
    - an N-process run gives each process's t_self for ITS b_per_proc
      captures and the barrier cost t_comm. The N processes compute in
      barrier-coordinated turns, so each t_self is what N hosts would run
      side by side, since the capture axis needs no traffic between
      processes during the sweep. T_N = max_p(t_self) + t_comm;
      scaling = rate_N / (N * rate_1) with rate_N over N*b samples.

    Wall-clock samples on a shared host are noisy in both directions, so
    the estimator is the lower-middle order statistic of TWO full
    ``n_meas``-sample sets pooled (2*n_meas samples): a fixed,
    unconditional stopping rule; every sample's scaling is returned in
    ``scaling_samples``.
    """
    meas = [_measure_sweep_once(n_procs, b_per_proc, devices_per_proc,
                                n_f, n_cap, reps, timeout)
            for _ in range(2 * max(1, n_meas))]
    meas.sort(key=lambda m: m["scaling"])
    # Even pool: the lower-middle order statistic (conservative median).
    res = dict(meas[(len(meas) - 1) // 2],
               scaling_samples=[m["scaling"] for m in meas])
    if verbose:
        print(f"multihost sweep scaling: {res}")
    return res


if __name__ == "__main__":
    _worker_main()
