"""The wideband search on an sc16 recording (interleaved int16 I/Q at
30.72 Msps, io/raw.py::load_sc16, the CLI's --wideband-sc16) against the
plain float64 chain, on the CPU (device="cpu": plain PyTorch).

The plain chain is tests/plain_wideband.py (each carrier channelized from
the definition in float64; an equal copy is the benchmark's reference,
benchmark/reference/channelize.py), then the benchmark's float64 search
(benchmark/reference/search.py). Tolerances: the int16 planes exact (the
scale 1/32768 is a power of two); the channels within 2e-4 x max, the
tolerance search/wideband.py states for its float32 channelizer (TF32
would cost more: the same channelizer fed TF32-rounded samples and taps
misses it); decoded IDs, CP, RB, ports, SFN and PHICH exact,
freq_superfine within 0.5 Hz (as the sweep tests allow).
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_wideband
from benchmark.control import tf32_round
from benchmark.reference import channelize as bench_channelize
from benchmark.reference.search import cell_search as plain_search
from lte_cell_scanner_tpu_torch.io.raw import load_sc16
from lte_cell_scanner_tpu_torch.search import cli
from lte_cell_scanner_tpu_torch.search import wideband as wb
from torch_one_thread import _one_torch_thread  # noqa: F401
from torch_wide import FC_CENTER, to_sc16, wide_two_cells

FS_IN = 30.72e6
FSET = np.arange(-2, 3) * 5e3
FCS = [FC_CENTER + 2.0e6, FC_CENTER - 1.5e6]
DECODED = ("n_id_2", "n_id_1", "cp_type", "n_rb_dl", "n_ports", "sfn",
           "phich_duration", "phich_resource")
COPIES = [Path(plain_wideband.__file__), Path(bench_channelize.__file__)]


@pytest.fixture(scope="module")
def two_cells():
    """Cell 271 at +2.0 MHz and cell 90 at -1.5 MHz of a 30.72 Msps
    recording around FC_CENTER, as sc16."""
    sig, fs_in = wide_two_cells(decim=16)
    assert fs_in == FS_IN
    return to_sc16(sig)


@pytest.fixture(scope="module")
def sc16_file(two_cells, tmp_path_factory):
    path = tmp_path_factory.mktemp("sc16") / "wide.sc16"
    two_cells.tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def noise16():
    """A short full-band noise recording (1,024 outputs) and 16 carriers
    of its raster, the two outer ones included."""
    rng = np.random.default_rng(11)
    n_out = 1024
    sc = np.round(rng.standard_normal(((n_out + 10) * 16, 2)) * 2000)
    fcs = wb.wideband_carriers(FS_IN, FC_CENTER, 0.0, 2e9)
    pick = np.round(np.linspace(0, len(fcs) - 1, 16)).astype(int)
    return sc.astype(np.int16), [fcs[i] for i in pick], n_out


def test_load_sc16_round_trip(tmp_path):
    a = np.array([[1, -2], [32767, -32768], [0, 7]], dtype=np.int16)
    path = tmp_path / "x.sc16"
    a.tofile(path)
    got = load_sc16(str(path))
    assert got.dtype == np.int16 and got.shape == (3, 2)
    assert np.array_equal(got, a)
    with open(path, "ab") as f:            # a trailing odd value
        f.write(np.int16(5).tobytes())
    assert np.array_equal(load_sc16(str(path)), a)


def test_int16_planes_are_exact(noise16):
    sc, _, _ = noise16
    planes = wb.wide_planes(sc, torch.device("cpu"))
    assert planes.dtype == torch.float32 and planes.shape == (2, len(sc))
    assert planes.is_contiguous()
    want = sc.astype(np.float64).T / 32768
    assert np.array_equal(planes.numpy().astype(np.float64), want)


def test_channelizer_matches_plain(noise16):
    """The filter bank (full float32) within 2e-4 x max of the float64
    definition at 16 carriers across the band; fed TF32-rounded samples
    and taps, the same bank misses that tolerance."""
    sc, fcs, n_out = noise16
    ch = wb.make_channelizer(FS_IN, FC_CENTER, fcs, len(sc), n_out,
                             device="cpu")
    planes = wb.wide_planes(sc, ch.device)
    got = ch(planes).numpy()
    kern = ch.kern
    try:
        ch.kern = torch.from_numpy(tf32_round(kern.numpy())
                                   .astype(np.float32))
        tf32 = ch(torch.from_numpy(tf32_round(planes.numpy())
                                   .astype(np.float32))).numpy()
    finally:
        ch.kern = kern
    worst, worst_tf32 = 0.0, 0.0
    for i, fc in enumerate(fcs):
        want = plain_wideband.channelize(sc, FS_IN, FC_CENTER, fc, n_out)
        scale = np.abs(want).max()
        worst = max(worst, np.abs(got[i, 0] + 1j * got[i, 1] - want).max()
                    / scale)
        worst_tf32 = max(worst_tf32, np.abs(tf32[i, 0] + 1j * tf32[i, 1]
                                            - want).max() / scale)
    assert worst < 2e-4
    assert worst_tf32 > 2e-4


def test_plain_copies_are_equal(noise16):
    sc, fcs, n_out = noise16
    assert COPIES[0].read_text() == COPIES[1].read_text()
    for fc in (fcs[0], fcs[-1]):
        a = plain_wideband.channelize(sc, FS_IN, FC_CENTER, fc, n_out)
        b = bench_channelize.channelize(sc, FS_IN, FC_CENTER, fc, n_out)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("path", COPIES, ids=["tests", "benchmark"])
def test_plain_reference_imports_no_program(path):
    """The plain reference imports no JAX and no module of either
    package: numpy, torch and the standard library only."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names - {"__future__"} <= {"math", "numpy", "torch"} | set(
        sys.stdlib_module_names), names


def _decoded(per_cap):
    return [[tuple(getattr(c, f) for f in DECODED) for c in cells]
            for cells in per_cap]


def test_sweep_matches_plain_chain(two_cells):
    """The sc16 recording through wideband_search_sweep on the CPU gives
    the plain chain's cells, carrier by carrier."""
    per_cap, deduped = wb.wideband_search_sweep(
        two_cells, FS_IN, FC_CENTER, FCS, FSET, device="cpu", interp="hex")
    plain = [plain_search(plain_wideband.channelize(two_cells, FS_IN,
                                                    FC_CENTER, fc),
                          fc, FSET, interp="hex") for fc in FCS]
    assert [[c.n_id_cell() for c in p] for p in per_cap] == [[271], [90]]
    assert _decoded(per_cap) == _decoded(plain)
    assert max(abs(a.freq_superfine - b.freq_superfine)
               for p, q in zip(per_cap, plain) for a, b in zip(p, q)) < 0.5
    assert sorted(c.n_id_cell() for c in deduped) == [90, 271]


def test_cli_wideband_sc16(sc16_file, capsys):
    rc = cli.main(["-s", "741e6", "-p", "10", "--device", "cpu",
                   "--wideband", sc16_file, "--wideband-sc16",
                   "--fs-in", "30.72e6", "--fc-center", str(FC_CENTER)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "741 MHz: cell ID 271" in out
    assert out.splitlines()[-1].split()[0] == "271"


@pytest.mark.parametrize("drop,message", [
    ("--fs-in", "Error: --wideband-sc16 requires --fs-in (the recording's "
                "sample rate in Hz)"),
    ("--fc-center", "Error: --wideband-sc16 requires --fc-center"),
    ("--wideband-rtl-sdr", "Error: --wideband-rtl-sdr and --wideband-sc16 "
                           "are mutually exclusive")])
def test_cli_wideband_sc16_errors(sc16_file, drop, message):
    flags = {"--fs-in": ["--fs-in", "30.72e6"],
             "--fc-center": ["--fc-center", str(FC_CENTER)]}
    argv = ["-s", "741e6", "--device", "cpu", "--wideband", sc16_file,
            "--wideband-sc16"]
    for flag, value in flags.items():
        if flag != drop:
            argv += value
    if drop == "--wideband-rtl-sdr":
        argv.append(drop)
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    assert str(got.value) == message
