"""The port's cell search end to end (device="cpu": the kernels' plain
versions) vs the JAX package's cell_search(backend="jax") on simulator
captures; device selection; and the rule that the port never imports JAX
or the JAX package.
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.search.cell_search import \
    cell_search as jax_cell_search
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.search import cli
from lte_cell_scanner_tpu_torch.search.cell_search import (
    cell_search, generate_search_sets)
from torch_one_thread import _one_torch_thread  # noqa: F401


REPO = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("fc_requested", "n_id_2", "n_id_1", "cp_type", "frame_start",
          "n_ports", "n_rb_dl", "phich_duration", "phich_resource", "sfn")


@pytest.mark.parametrize("kw,fset", [
    # tests/test_simulator.py::test_closed_loop_decode
    (dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10,
          freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3),
     np.arange(-3, 4) * 5e3),
    (dict(n_id_1=0, n_id_2=0, cp_type="normal", snr_db=10,
          freq_offset=-3.3e3, n_rb_dl=6, sfn_start=64, seed=3),
     np.arange(-3, 4) * 5e3),
    (dict(n_id_1=167, n_id_2=2, cp_type="extended", snr_db=10,
          freq_offset=11e3, n_rb_dl=100, sfn_start=64, seed=3),
     np.arange(-3, 4) * 5e3),
    # tests/test_device_decode.py::test_device_decode_extended_cp
    (dict(n_id_1=30, n_id_2=2, cp_type="extended", snr_db=20.0,
          freq_offset=2e3, n_rb_dl=25, seed=3),
     np.arange(-2, 3) * 5e3),
])
def test_cell_search_matches_jax(kw, fset):
    cap = synthetic_capture(**kw)
    got = cell_search(cap, 739e6, f_search_set=fset, device="cpu")
    want = jax_cell_search(cap, 739e6, f_search_set=fset, backend="jax")
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert [getattr(g, f) for f in FIELDS] == \
            [getattr(w, f) for f in FIELDS]
        assert abs(g.freq_superfine - w.freq_superfine) < 0.5
    assert got[0].n_id_cell() == 3 * kw["n_id_1"] + kw["n_id_2"]
    assert got[0].n_rb_dl == kw["n_rb_dl"]


def test_table_full_fallback_matches_jax(monkeypatch):
    """A full peak table (MAX_PEAKS lowered to 1) sends the search down the
    host peak search over the device's scan tables; the cells still equal
    the JAX package's."""
    # The module (the package's ``cell_search`` is the function).
    cs = importlib.import_module(
        "lte_cell_scanner_tpu_torch.search.cell_search")

    calls = []
    host_peak_search = cs.peak_search

    def spy(*args, **kwargs):
        calls.append(1)
        return host_peak_search(*args, **kwargs)

    monkeypatch.setattr(cs, "MAX_PEAKS", 1)
    monkeypatch.setattr(cs, "peak_search", spy)
    kw = dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10,
              freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3)
    fset = np.arange(-3, 4) * 5e3
    cap = synthetic_capture(**kw)
    got = cs.cell_search(cap, 739e6, f_search_set=fset, device="cpu")
    assert calls == [1]
    want = jax_cell_search(cap, 739e6, f_search_set=fset, backend="jax")
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert [getattr(g, f) for f in FIELDS] == \
            [getattr(w, f) for f in FIELDS]
        assert abs(g.freq_superfine - w.freq_superfine) < 0.5


def test_table_full_redo_stays_on_device(monkeypatch):
    """A full first-pass table (MAX_PEAKS lowered to 1) is redone by the
    unbounded greedy search, PEAK_BOUND trips of the device loop, on the
    scan's own device (ops/peak_torch.redo_full_tables): the host
    peak_search is patched to raise, in ops/peak.py and under every name
    that search/cell_search.py binds it to. The redone peaks equal the
    JAX package's host search over its float64 scan (n_id_2, ind, freq),
    and the cells the JAX cell_search's."""
    from lte_cell_scanner_tpu.ops.peak import peak_search as jax_peaks
    from lte_cell_scanner_tpu.ops.xcorr import xcorr_pss
    from lte_cell_scanner_tpu.search.cell_search import detection_threshold
    from lte_cell_scanner_tpu_torch.ops import peak as host_peak
    from lte_cell_scanner_tpu_torch.ops import peak_torch
    # The module (the package's ``cell_search`` is the function).
    cs = importlib.import_module(
        "lte_cell_scanner_tpu_torch.search.cell_search")

    def host_search(*args, **kwargs):
        raise AssertionError("the host peak_search ran")

    host = host_peak.peak_search
    for mod in (host_peak, cs):
        for name, value in list(vars(mod).items()):
            if value is host:
                monkeypatch.setattr(mod, name, host_search)
    runs = []
    device_search = peak_torch.peak_search_device

    def spy(packed, single, r_norm, ds_comb_arm,
            max_peaks=peak_torch.MAX_PEAKS, early_exit=True):
        table = device_search(packed, single, r_norm, ds_comb_arm,
                              max_peaks, early_exit)
        runs.append((max_peaks, packed.device, table))
        return table

    monkeypatch.setattr(cs, "MAX_PEAKS", 1)
    monkeypatch.setattr(cs, "peak_search_device", spy)
    monkeypatch.setattr(peak_torch, "peak_search_device", spy)
    kw = dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10,
              freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3)
    fset = np.arange(-3, 4) * 5e3
    cap = synthetic_capture(**kw)
    got = cs.cell_search(cap, 739e6, f_search_set=fset, device="cpu")
    assert {m for m, _, _ in runs} == {1, peak_torch.PEAK_BOUND}
    (dev, table), = [(d, t) for m, d, t in runs
                     if m == peak_torch.PEAK_BOUND]
    assert dev == table.device == torch.device("cpu")
    r = xcorr_pss(cap, fset, 2, 739e6, 739e6, 1.92e6, backend="numpy")
    want = jax_peaks(r.xc_incoherent_collapsed_pow,
                     r.xc_incoherent_collapsed_frq,
                     detection_threshold(r.sp_incoherent, r.n_comb_xc),
                     fset, 739e6, 739e6, r.xc_incoherent_single, 2)
    peaks = peak_torch.peaks_to_cells(table[0].numpy(), fset, 739e6, 739e6)
    assert len(want) >= 2
    assert [(c.n_id_2, c.ind, c.freq) for c in peaks] == \
        [(c.n_id_2, c.ind, c.freq) for c in want]
    cells = jax_cell_search(cap, 739e6, f_search_set=fset, backend="jax")
    assert [getattr(g, f) for g in got for f in FIELDS] == \
        [getattr(w, f) for w in cells for f in FIELDS] and cells


def test_search_sets_full_grid():
    fcs, fset = generate_search_sets(739e6, 739e6, 100)
    assert list(fcs) == [739e6] and len(fset) == 31
    assert fset[0] == -75e3 and fset[-1] == 75e3


def test_default_device_needs_cuda(monkeypatch):
    """device=None means the CUDA card: without one the search raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cell_search(np.zeros(20000, complex), 739e6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--freq-start", "739e6", "--simulate", "-b"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "lte_cell_scanner_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    assert {"runtime.py", "batch_runtime.py", "cli.py", "display.py",
            "curses_display.py", "native_feeder.py"} <= {
        p.name for p in files if p.parent.name == "tracker"}
    assert {"bench_scan.py", "bench_decode.py", "bench_viterbi.py",
            "bench_tracker.py", "mc_search.py", "rtl_sdr_check.py",
            "noise_bias.py", "pss_ambiguity.py", "profile_pipeline.py",
            "bench_wideband.py"} <= {
        p.name for p in files if p.parent.name == "tools"}
    assert {"io/capture.py", "parallel/fc_sweep.py", "search/pipeline.py",
            "io/frontend.py", "search/wideband.py",
            "parallel/sharded_search.py", "parallel/multihost.py",
            "parallel/multichip_checks.py"} <= {
        f"{p.parent.name}/{p.name}" for p in files}
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes",
                               "lte_cell_scanner_tpu"), \
                f"{path.relative_to(REPO)} imports {name}"


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the kernel build raises (no silent plain
    fallback); importing the package built nothing."""
    from lte_cell_scanner_tpu_torch.kernels import build

    assert not build._LIBS
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["viterbi"])
    assert build.library_path("viterbi").parent == tmp_path
