"""The port's float64 host chain (``backend="numpy"``: utils/dsp.py,
ops/{xcorr,sync,tfg,chanest,pbch}.py, cell_search and the search CLI)
against the JAX package's, stage by stage on the same inputs.

The port's host chain is a copy of the JAX package's numpy code, so every
output must be equal to the bit: arrays with assert_array_equal, Cell
records field by field, the CLI's result table line for line.
"""

import dataclasses
import importlib

import numpy as np
import pytest

from lte_cell_scanner_tpu.models.cell import Cell as JaxCell
from lte_cell_scanner_tpu.models.rs import RSDL as JaxRSDL
from lte_cell_scanner_tpu.ops import chanest as jchanest
from lte_cell_scanner_tpu.ops import pbch as jpbch
from lte_cell_scanner_tpu.ops import peak as jpeak
from lte_cell_scanner_tpu.ops import sync as jsync
from lte_cell_scanner_tpu.ops import tfg as jtfg
from lte_cell_scanner_tpu.ops import xcorr as jxcorr
from lte_cell_scanner_tpu.search.cell_search import (
    cell_search as jax_cell_search, detection_threshold as jax_threshold)
from lte_cell_scanner_tpu.search import cli as jax_cli
from lte_cell_scanner_tpu.utils import dsp as jdsp
from lte_cell_scanner_tpu_torch.constants import DS_COMB_ARM, THRESH2_N_SIGMA
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.models.rs import RSDL
from lte_cell_scanner_tpu_torch.ops import chanest, pbch, sync, tfg, xcorr
from lte_cell_scanner_tpu_torch.search import cli
from lte_cell_scanner_tpu_torch.utils import dsp
from torch_one_thread import _one_blas_thread, _one_torch_thread  # noqa: F401

# The module (the package's ``cell_search`` is the function).
cs = importlib.import_module("lte_cell_scanner_tpu_torch.search.cell_search")

FC, FS = 739e6, 1.92e6
FSET = np.arange(-2, 3) * 5e3
CAPTURES = {
    # tests/test_torch_mib.py::CAPTURES
    "normal": dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10.0,
                   freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3),
    "extended": dict(n_id_1=30, n_id_2=2, cp_type="extended", snr_db=20.0,
                     freq_offset=2e3, n_rb_dl=25, seed=3),
}


def _port(cell: JaxCell) -> Cell:
    return Cell(**dataclasses.asdict(cell))


def _same_cell(got: Cell, want: JaxCell) -> None:
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module", params=sorted(CAPTURES))
def chain(request):
    """The JAX host chain's value at every stage on one capture: (cap,
    xcorr result, threshold, peaks, synced, fine, tfg, ts, tfoec)."""
    cap = synthetic_capture(**CAPTURES[request.param])
    r = jxcorr.xcorr_pss(cap, FSET, DS_COMB_ARM, FC, FC, FS)
    z = jax_threshold(r.sp_incoherent, r.n_comb_xc, DS_COMB_ARM)
    peaks = jpeak.peak_search(r.xc_incoherent_collapsed_pow,
                              r.xc_incoherent_collapsed_frq, z, FSET, FC,
                              FC, r.xc_incoherent_single, DS_COMB_ARM, FS)
    synced = [jsync.sss_detect(p, cap, THRESH2_N_SIGMA, FC, FC, FS)
              for p in peaks]
    alive = [c for c in synced if c.n_id_1 >= 0]
    assert alive
    fine = jsync.pss_sss_foe(alive[0], cap, FC, FC, FS)
    grid, ts = jtfg.extract_tfg(fine, cap, FC, FC, FS)
    rs_dl = JaxRSDL(fine.n_id_cell(), 6, fine.cp_type)
    comp = jtfg.tfoec(fine, grid, ts, FC, FC, rs_dl)
    return dict(cap=cap, r=r, z=z, peaks=peaks, synced=synced, fine=fine,
                tfg=grid, ts=ts, comp=comp)


def test_xcorr_pss_matches_jax(chain):
    r = xcorr.xcorr_pss(chain["cap"], FSET, DS_COMB_ARM, FC, FC, FS,
                        keep_xc=True)
    w = chain["r"]
    for f in ("xc_incoherent_collapsed_pow", "xc_incoherent_collapsed_frq",
              "xc_incoherent_single", "xc_incoherent", "sp_incoherent",
              "sp"):
        np.testing.assert_array_equal(getattr(r, f), getattr(w, f), f)
    assert (r.n_comb_xc, r.n_comb_sp) == (w.n_comb_xc, w.n_comb_sp)
    assert r.xc.shape == (3, len(chain["cap"]) - 136, len(FSET))
    np.testing.assert_array_equal(
        cs.detection_threshold(r.sp_incoherent, r.n_comb_xc), chain["z"])
    # The host scan is the only backend here.
    with pytest.raises(ValueError):
        xcorr.xcorr_pss(chain["cap"], FSET, DS_COMB_ARM, FC, FC, FS,
                        backend="torch")


def test_sss_detect_matches_jax(chain):
    for p, want in zip(chain["peaks"], chain["synced"]):
        got, dbg = sync.sss_detect(_port(p), chain["cap"], THRESH2_N_SIGMA,
                                   FC, FC, FS, want_debug=True)
        _same_cell(got, want)
        _, jdbg = jsync.sss_detect(p, chain["cap"], THRESH2_N_SIGMA, FC, FC,
                                   FS, want_debug=True)
        for f in dataclasses.fields(jdbg):
            np.testing.assert_array_equal(getattr(dbg, f.name),
                                          getattr(jdbg, f.name), f.name)


def test_pss_sss_foe_matches_jax(chain):
    alive = [c for c in chain["synced"] if c.n_id_1 >= 0]
    _same_cell(sync.pss_sss_foe(_port(alive[0]), chain["cap"], FC, FC, FS),
               chain["fine"])


def test_extract_tfg_matches_jax(chain):
    grid, ts = tfg.extract_tfg(_port(chain["fine"]), chain["cap"], FC, FC,
                               FS)
    np.testing.assert_array_equal(grid, chain["tfg"])
    np.testing.assert_array_equal(ts, chain["ts"])
    assert grid.shape == (854 if chain["fine"].cp_type == "normal" else 732,
                          72)


def test_tfoec_matches_jax(chain):
    fine = chain["fine"]
    rs_dl = RSDL(fine.n_id_cell(), 6, fine.cp_type)
    cell, comp, comp_ts = tfg.tfoec(_port(fine), chain["tfg"], chain["ts"],
                                    FC, FC, rs_dl)
    _same_cell(cell, chain["comp"][0])
    np.testing.assert_array_equal(comp, chain["comp"][1])
    np.testing.assert_array_equal(comp_ts, chain["comp"][2])


@pytest.mark.parametrize("interp", ["hex", "freq_time", "2stage"])
def test_chan_est_matches_jax(chain, interp):
    cell = chain["comp"][0]
    rs_dl = RSDL(cell.n_id_cell(), 6, cell.cp_type)
    jrs_dl = JaxRSDL(cell.n_id_cell(), 6, cell.cp_type)
    for port in range(4):
        ce, np_est = chanest.chan_est(_port(cell), rs_dl, chain["comp"][1],
                                      port, interp=interp)
        jce, jnp_est = jchanest.chan_est(cell, jrs_dl, chain["comp"][1],
                                         port, interp=interp)
        np.testing.assert_array_equal(ce, jce)
        assert np_est == jnp_est
    with pytest.raises(ValueError):
        chanest.chan_est(_port(cell), rs_dl, chain["comp"][1], 0,
                         interp="cubic")


@pytest.mark.parametrize("interp", ["hex", "freq_time", "2stage"])
def test_decode_mib_matches_jax(chain, interp):
    cell, comp, _ = chain["comp"]
    got = pbch.decode_mib(_port(cell), comp,
                          RSDL(cell.n_id_cell(), 6, cell.cp_type),
                          interp=interp)
    want = jpbch.decode_mib(cell, comp,
                            JaxRSDL(cell.n_id_cell(), 6, cell.cp_type),
                            interp=interp)
    _same_cell(got, want)
    assert got.n_rb_dl > 0


@pytest.mark.parametrize("cp", sorted(CAPTURES))
def test_cell_search_numpy_matches_jax(cp):
    """cell_search(backend="numpy") is the JAX package's default search,
    to the bit; the port's default stays the card's backend."""
    cap = synthetic_capture(**CAPTURES[cp])
    got = cs.cell_search(cap, FC, f_search_set=FSET, backend="numpy",
                         device="cpu")
    want = jax_cell_search(cap, FC, f_search_set=FSET, backend="numpy")
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        _same_cell(g, w)
    kw = CAPTURES[cp]
    assert got[0].n_id_cell() == 3 * kw["n_id_1"] + kw["n_id_2"]
    assert got[0].n_rb_dl == kw["n_rb_dl"]
    # Against the device backend's search (its plain versions here): the
    # same cells and MIB fields, freq_superfine within 0.5 Hz (the bound
    # of tests/test_torch_cell_search.py for two searches).
    dev = cs.cell_search(cap, FC, f_search_set=FSET, device="cpu")
    fields = ("n_id_2", "n_id_1", "cp_type", "n_ports", "n_rb_dl",
              "phich_duration", "phich_resource", "sfn")
    assert [[getattr(c, f) for f in fields] for c in dev] == \
        [[getattr(c, f) for f in fields] for c in got]
    assert abs(dev[0].freq_superfine - got[0].freq_superfine) < 0.5
    assert abs(dev[0].frame_start - got[0].frame_start) < 1e-3
    with pytest.raises(ValueError):
        cs.cell_search(cap, FC, f_search_set=FSET, backend="jax")


def _table(out):
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("CID A"))
    return [ln for ln in lines[i + 1:] if ln.strip()]


def test_search_cli_numpy_backend_matches_jax(capsys):
    """``--backend numpy --interp 2stage`` runs the 2stage interpolator on
    the float64 chain: the same result table as the JAX CLI, letter for
    letter. The batched sweeps stay on the device's backend."""
    base = ["--freq-start", "739e6", "--ppm", "15", "--simulate",
            "--interp", "2stage", "-b"]
    assert cli.main(base + ["--backend", "numpy", "--device", "cpu"]) == 0
    got = _table(capsys.readouterr().out)
    assert jax_cli.main(base + ["--backend", "numpy"]) == 0
    want = _table(capsys.readouterr().out)
    assert got == want and [g.split()[0] for g in got] == ["271"]
    for extra in (["--batch-sweep"], ["--wideband", "x.it"]):
        with pytest.raises(SystemExit):
            cli.main(base + ["--backend", "numpy", "--device", "cpu"]
                     + extra)


@pytest.mark.parametrize("name", [
    "dft", "tshift", "sigpower", "absx2", "db20", "udb20", "blnoise",
    "chi2cdf", "matlab_mod", "diff", "and_reduce", "last", "flatten"])
def test_dsp_helpers_match_jax(name):
    """The 13 helpers of utils/dsp.py the host chain brought in, on seeded
    inputs (blnoise from the same seeded generator)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    args = {
        "dft": lambda: (x,), "tshift": lambda: (x, 5),
        "sigpower": lambda: (x,), "absx2": lambda: (x,),
        "db20": lambda: (np.abs(x),), "udb20": lambda: (x.real,),
        "blnoise": lambda: (32, np.random.default_rng(9)),
        "chi2cdf": lambda: (7.5, 6), "matlab_mod": lambda: (x.real * 9, -4),
        "diff": lambda: (x,), "and_reduce": lambda: (x.real > -5,),
        "last": lambda: (x.reshape(8, 8),),
        "flatten": lambda: ([x[:3], x[3:9].reshape(2, 3)],)}[name]
    got, want = getattr(dsp, name)(*args()), getattr(jdsp, name)(*args())
    np.testing.assert_array_equal(got, want)
    assert type(got) is type(want)
    if name == "tshift":
        with pytest.raises(ValueError):
            dsp.tshift(x, 1.5)
