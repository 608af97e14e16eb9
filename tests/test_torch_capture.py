"""The port's capture front end (lte_cell_scanner_tpu_torch/io/capture.py)
and its CellSearch CLI's capture flags, against the JAX package's: the
E4000 PLL model and the RTL2832 rate exactly, recordings byte-compatible
both ways, and the CLI's --record / --load result table.
"""

import numpy as np
import pytest

from lte_cell_scanner_tpu.io import capture as jax_capture
from lte_cell_scanner_tpu.search import cli as jax_cli
from lte_cell_scanner_tpu_torch.io import capture
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.search import cli
from torch_one_thread import _one_torch_thread  # noqa: F401


def test_pll_model_and_rate_match_jax():
    """Exact equality over a grid that crosses every _PLL_VARS edge (one
    Hz below, at and above each) and the LTE bands around them."""
    edges = [f for f, _, _ in capture._PLL_VARS]
    assert edges == [f for f, _, _ in jax_capture._PLL_VARS]
    grid = [f + d for f in edges for d in (-1, 0, 1)]
    grid += list(np.arange(50e6, 2.2e9, 37.3e6)) + [739e6, 751.7e6, 2.6e9]
    for fosc in (28.8e6, 28.8e6 * 1.00002):
        for f in grid:
            assert capture.compute_fc_programmed(fosc, f) == \
                jax_capture.compute_fc_programmed(fosc, f), (fosc, f)
    for fs in (1.92e6, 1.92e6 * 1.0001, 1.4e6, 2.4e6, 3.2e6):
        for xtal in (28.8e6, 28.8e6 * 0.99998):
            assert capture.fs_programmed_rtl2832(fs, xtal) == \
                jax_capture.fs_programmed_rtl2832(fs, xtal)


@pytest.mark.parametrize("fc,fc_prog,dtype,prog", [
    (739e6, None, np.int32, 739e6),                   # int32 fc
    (739e6, 739e6 + 58.0, np.int32, 739e6 + 58.0),    # + fc_programmed
    (2.6e9, 2.6e9 - 12.5, np.float64, 2.6e9 - 12.5),  # float64 (> int32)
    (739.05e6 + 0.25, None, np.int32, 739.05e6),      # rounds to int32
    (739.05e6 + 0.5, None, np.float64, 739.05e6 + 0.5),  # half: float64
])
def test_capbuf_round_trip_and_jax_compatible(tmp_path, fc, fc_prog, dtype,
                                              prog):
    """save_capbuf -> load_capbuf round-trips; the port's file is the JAX
    package's byte for byte, and each reads the other's. The fc field is
    an int32 unless it is more than half a hertz from an integer or above
    2.147 GHz."""
    from lte_cell_scanner_tpu_torch.io.itfile import load_it

    cap = synthetic_capture(n_subframes=4, seed=1)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    p = capture.save_capbuf(str(mine), 3, cap, fc, fc_programmed=fc_prog)
    q = jax_capture.save_capbuf(str(theirs), 3, cap, fc,
                                fc_programmed=fc_prog)
    assert p.endswith("capbuf_0003.it")
    assert open(p, "rb").read() == open(q, "rb").read()
    assert load_it(p)["fc"].dtype == dtype
    for load in (capture.load_capbuf, jax_capture.load_capbuf):
        for d in (mine, theirs):
            got, got_prog = load(str(d), 3)
            np.testing.assert_array_equal(got, cap)
            assert got_prog == prog


def test_capture_source_file_and_simulator(tmp_path):
    src = capture.CaptureSource("simulator", data_dir=str(tmp_path),
                                record=True, n_subframes=4, seed=2)
    a, prog = src.capture(739e6)
    b, _ = src.capture(739.1e6)
    assert prog == 739e6 and src.capture_number == 2
    replay = capture.CaptureSource("file", data_dir=str(tmp_path))
    for want, fc in ((a, 739e6), (b, 739.1e6)):
        got, prog = replay.capture(fc)
        np.testing.assert_array_equal(got, want)
        assert prog == fc
    with pytest.raises(FileNotFoundError):
        replay.capture(739.2e6)
    with pytest.raises(ValueError):
        capture.CaptureSource("usb")


def test_rtlsdr_backend_needs_pyrtlsdr(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "rtlsdr", None)   # import fails
    with pytest.raises(RuntimeError, match="pyrtlsdr"):
        capture.CaptureSource("rtlsdr")


def _table(out: str):
    """The result table's rows: [CID, A, fc, foff, RXPWR, C, nRB, P, PR,
    correction]."""
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("CID A"))
    return [ln.split() for ln in lines[i + 1:] if ln.strip()]


def test_cli_record_then_load_matches_jax(tmp_path, capsys):
    """Two simulator captures recorded by the port's CLI (-r --simulate);
    the second is then replaced by another cell (503, extended CP, on the
    E4000 tuner's programmed carrier), so that the table holds two rows
    that no near tie can swap. Both recordings are searched by the JAX
    CLI and by the port's (--load): the same table (CID, A, fc, C, nRB, P,
    PR exact; the crystal correction factor within 1e-9 relative, the
    freq_superfine of two float32 programs)."""
    d = str(tmp_path)
    base = ["--freq-start", "739e6", "--freq-end", "739.1e6", "--ppm", "15",
            "-b"]
    assert cli.main(base + ["--simulate", "-r", "-d", d,
                            "--device", "cpu"]) == 0
    assert [r[0] for r in _table(capsys.readouterr().out)] == ["271"]
    for i in range(2):
        cap, prog = capture.load_capbuf(d, i)
        np.testing.assert_array_equal(cap, synthetic_capture())
        assert prog == 739e6 + 100e3 * i
    capture.save_capbuf(d, 1, synthetic_capture(
        n_id_1=167, n_id_2=2, cp_type="extended", freq_offset=-4e3,
        n_rb_dl=100, seed=3), 739.1e6,
        fc_programmed=capture.compute_fc_programmed(28.8e6, 739.1e6) + 58)
    assert jax_cli.main(base + ["--load", "-d", d]) == 0
    want = _table(capsys.readouterr().out)
    assert [w[0] for w in want] == ["271", "503"]
    for extra in ([], ["--interp", "2stage"], ["--batch-sweep"]):
        assert cli.main(base + ["--load", "-d", d, "--device", "cpu"]
                        + extra) == 0
        got = _table(capsys.readouterr().out)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            keep = [0, 1, 2, 5, 6, 7, 8]
            assert [g[k] for k in keep] == [w[k] for k in keep], extra
            assert float(g[9]) == pytest.approx(float(w[9]), rel=1e-9)
    # --record and --load exclude each other, as in the JAX CLI.
    with pytest.raises(SystemExit):
        cli.main(base + ["--load", "-r", "-d", d, "--device", "cpu"])
