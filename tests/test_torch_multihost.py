"""The port's multi-process runs (parallel/multihost.py) on the CPU: real
OS processes joined by torch.distributed over gloo on localhost, the
(seq, hyp) mesh spanning the process boundary, 1e-12 full-table parity
with the port's float64 scan asserted in every process (the size of the
JAX package's tests/test_multihost.py::test_two_process_parity); the
sweep-scaling estimator; and the collective path of the sharded scan in
one process (world size 1), which the chip smoke runs over NCCL.

The JAX package's load-dependent scaling gate (scaling >= 0.9) has no
copy here: it measures the host's load, not the port.
"""

import socket

import numpy as np
import torch.distributed as dist

from lte_cell_scanner_tpu.ops.xcorr import xcorr_pss
from lte_cell_scanner_tpu_torch.parallel import multichip_checks as mc
from lte_cell_scanner_tpu_torch.parallel.multichip_checks import \
    planted_capture
from lte_cell_scanner_tpu_torch.parallel.multihost import (dryrun_multihost,
                                                           init_multihost)
from lte_cell_scanner_tpu_torch.parallel.sharded_search import (
    make_search_mesh, sharded_xcorr_pss)
from torch_one_thread import _one_torch_thread  # noqa: F401


def test_two_process_parity():
    # 2 processes x 2 CPU shards, mesh seq 2 x hyp 2: the fold all_reduce
    # crosses the process boundary. Each worker has its own 300 s limit.
    dryrun_multihost(n_procs=2, devices_per_proc=2, n_cap=76800, n_f=4,
                     n_hyp=2, timeout=300.0, verbose=False)


def test_sweep_scaling_pooled_estimator(monkeypatch):
    """The estimator pools TWO full n_meas-sample sets and takes the
    lower-middle order statistic of the 2*n_meas samples: a fixed,
    unconditional stopping rule; all samples come back sorted."""
    from lte_cell_scanner_tpu_torch.parallel import multihost as mh

    seq = iter([1.8, 0.95, 2.0, 1.05, 0.9, 1.0])
    monkeypatch.setattr(
        mh, "_measure_sweep_once",
        lambda *a, **k: {"scaling": next(seq)})
    res = mh.measure_sweep_scaling(verbose=False, n_meas=3)
    # sorted pool: [0.9, 0.95, 1.0, 1.05, 1.8, 2.0] -> lower-middle 1.0
    assert res["scaling"] == 1.0
    assert res["scaling_samples"] == [0.9, 0.95, 1.0, 1.05, 1.8, 2.0]
    assert "scaling_samples_discarded_run" not in res


def test_collective_path_world_size_one():
    """One gloo process holding a 2 x 2 mesh: the collective path (local
    sums, all_reduce over the seq group, all_gather over the hyp group)
    gives the in-process combine's tables and the JAX float64 scan's."""
    cap, fset, fc = planted_capture(76800, 4)
    mesh_args = (2, 2)
    local = sharded_xcorr_pss(cap, fset, 2, fc, fc, 1.92e6,
                              make_search_mesh(*mesh_args,
                                               devices=["cpu"] * 4),
                              dtype=np.float64)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    init_multihost(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        out = sharded_xcorr_pss(cap, fset, 2, fc, fc, 1.92e6,
                                make_search_mesh(*mesh_args,
                                                 devices=["cpu"] * 4),
                                dtype=np.float64)
    finally:
        dist.destroy_process_group()
    mc.assert_scan_parity(out, local, atol=0.0)
    mc.assert_scan_parity(out, xcorr_pss(cap, fset, 2, fc, fc, 1.92e6,
                                         backend="numpy"))
