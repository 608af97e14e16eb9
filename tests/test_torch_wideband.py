"""The port's wideband search (search/wideband.py, the CLI's --wideband)
against the JAX package's on the same recording, on the CPU
(device="cpu": plain PyTorch).

Tolerances: the carrier raster and the channelizer's host tables are the
same numpy code, so they are bit-equal; channels within 2e-4 x max of the
JAX package's and of the float64 per-carrier decimation (the JAX tests'
tolerance for its float32 channelizer); decoded IDs, CP, n_rb_dl, ports,
SFN and PHICH exact, freq_superfine within 0.5 Hz (as the sweep tests
allow).
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.io.frontend import decimate_capture
from lte_cell_scanner_tpu.search import cli as jax_cli
from lte_cell_scanner_tpu.search import wideband as jax_wb
from lte_cell_scanner_tpu_torch.io.itfile import save_it
from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
from lte_cell_scanner_tpu_torch.search import cli
from lte_cell_scanner_tpu_torch.search import wideband as wb
from torch_one_thread import _one_torch_thread  # noqa: F401
from torch_wide import FC_CENTER, wide_two_cells

FSET = np.arange(-2, 3) * 5e3
FCS = [FC_CENTER + 2.0e6, FC_CENTER - 1.5e6, FC_CENTER + 3.0e6]
DECODED = ("n_id_2", "n_id_1", "cp_type", "n_rb_dl", "n_ports", "sfn",
           "phich_duration", "phich_resource")
FULL_BAND = (30.72e6, FC_CENTER, FC_CENTER - 15.36e6, FC_CENTER + 15.36e6)


@pytest.fixture(scope="module")
def wide():
    return wide_two_cells()


@pytest.fixture(scope="module")
def noise_band():
    """tests/test_wideband.py's full-band noise recording (40,960 samples
    at 30.72 Msps) and its 100 kHz raster."""
    rng = np.random.default_rng(11)
    n_wide = 40960
    sig = rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide)
    return sig, wb.wideband_carriers(*FULL_BAND)


def _close(got, want, rel=2e-4):
    return np.abs(got - want).max() < rel * np.abs(want).max()


@pytest.mark.parametrize("args", [
    (15.36e6, 739e6, 735e6, 743e6), FULL_BAND, (30.72e6, 739e6, 741e6, 741e6),
    (15.36e6, 739e6, 760e6, 770e6)], ids=["band", "full", "one", "none"])
def test_wideband_carriers_match_jax(args):
    got = wb.wideband_carriers(*args)
    assert got == jax_wb.wideband_carriers(*args)
    assert all(abs(fc % 100e3) < 1e-6 for fc in got)
    if args == FULL_BAND:
        # The full-band deployment: 296 carriers, 724.3-753.8 MHz.
        assert (len(got), got[0], got[-1]) == (296, 724.3e6, 753.8e6)


@pytest.mark.parametrize("case", ["two_cell", "full_band"])
def test_channelizer_tables_match_jax(wide, noise_band, case):
    """The modulated kernel and the two rotation tables, bit for bit."""
    if case == "two_cell":
        sig, fs_in = wide
        fcs, n_out = FCS, None
    else:
        sig, fcs = noise_band
        fs_in, n_out = FULL_BAND[0], 1024
    ch = wb.make_channelizer(fs_in, FC_CENTER, fcs, len(sig), n_out,
                             device="cpu")
    _, consts, want_n_out = jax_wb.make_channelizer(fs_in, FC_CENTER, fcs,
                                                    len(sig), n_out)
    assert ch.n_out == want_n_out
    for got, want in zip((ch.kern, ch.t1, ch.t2), consts):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert np.array_equal(got.numpy(), want)


def test_channelize_batch_matches_jax_and_host(wide):
    sig, fs_in = wide
    fcs = [FC_CENTER + 2.0e6, FC_CENTER - 1.5e6, FC_CENTER]
    got = wb.channelize_batch(sig, fs_in, FC_CENTER, fcs, device="cpu")
    assert got.shape == (3, 2, 153600) and got.is_contiguous()
    got = got.numpy()
    assert _close(got, np.asarray(jax_wb.channelize_batch(sig, fs_in,
                                                          FC_CENTER, fcs)))
    for i, fc in enumerate(fcs):
        host = decimate_capture(sig, fs_in,
                                freq_shift=fc - FC_CENTER)[:got.shape[2]]
        assert _close(got[i, 0] + 1j * got[i, 1], host)


def test_channelize_map_matches_bank(wide):
    """The per-carrier form against the filter bank, and against the JAX
    package's per-carrier form."""
    sig, fs_in = wide
    fcs = [FC_CENTER + 2.0e6, FC_CENTER - 1.5e6, FC_CENTER + 0.7e6]
    base = wb.channelize_batch_map(sig, fs_in, FC_CENTER, fcs,
                                   device="cpu").numpy()
    bank = wb.channelize_batch(sig, fs_in, FC_CENTER, fcs,
                               device="cpu").numpy()
    assert _close(bank, base)
    assert _close(base, np.asarray(jax_wb.channelize_batch_map(
        sig, fs_in, FC_CENTER, fcs)))


def test_channelize_map_outer_carrier(noise_band):
    """At 726.9 MHz of a 30.72 Msps recording around 739 MHz (shift -12.1
    MHz, period fs / gcd = 1,536 samples) the port's per-carrier form holds
    the float64 channelizer within 2e-4 x max, as at the band's edges; the
    JAX package's, whose float32 angles (-2 pi rate) x (t mod period)
    reach ~3,800 rad there, does not (ROADMAP.md, section 3)."""
    sig, fcs = noise_band
    fs_in, n_out = FULL_BAND[0], 1024
    sub = [726.9e6, fcs[0], fcs[-1]]
    got = wb.channelize_batch_map(sig, fs_in, FC_CENTER, sub, n_out=n_out,
                                  device="cpu").numpy()
    want = np.asarray(jax_wb.channelize_batch_map(sig, fs_in, FC_CENTER, sub,
                                                  n_out=n_out))
    for i, fc in enumerate(sub):
        host = decimate_capture(sig, fs_in,
                                freq_shift=fc - FC_CENTER)[:n_out]
        assert _close(got[i, 0] + 1j * got[i, 1], host)
        if i == 0:
            assert not _close(want[i, 0] + 1j * want[i, 1], host)


def test_channelize_full_band_raster(noise_band):
    """All 296 carriers of a 30.72 Msps recording in one pass, held to the
    float64 channelizer at the first, centre and last carriers and next
    to both edges."""
    sig, fcs = noise_band
    fs_in, n_out = FULL_BAND[0], 1024
    got = wb.channelize_batch(sig, fs_in, FC_CENTER, fcs, n_out=n_out,
                              device="cpu").numpy()
    assert got.shape == (296, 2, n_out)
    for i in (0, len(fcs) // 2, len(fcs) - 1, 1, len(fcs) - 2):
        host = decimate_capture(sig, fs_in,
                                freq_shift=fcs[i] - FC_CENTER)[:n_out]
        assert _close(got[i, 0] + 1j * got[i, 1], host)


def test_channelizer_rejects_bad_input(wide):
    sig, fs_in = wide
    ch = wb.make_channelizer(fs_in, FC_CENTER, FCS, len(sig), device="cpu")
    planes = wb.wide_planes(sig, ch.device)
    for bad in (planes.double(), planes[:, :ch.n_used - 1], planes[0]):
        with pytest.raises(ValueError, match="float32 planes"):
            ch(bad)
    with pytest.raises(ValueError, match="too short"):
        wb.make_channelizer(fs_in, FC_CENTER, FCS, 1000, n_out=153600,
                            device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        wb.wideband_search_sweep(sig, fs_in, FC_CENTER, FCS, FSET,
                                 device="cpu", backend="jax")
    if torch.cuda.is_available():
        return
    # No silent CPU fallback: without CUDA the entry points raise.
    for call in (lambda: wb.wideband_search_sweep(sig, fs_in, FC_CENTER,
                                                  FCS, FSET),
                 lambda: wb.channelize_batch(sig, fs_in, FC_CENTER, FCS)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _decoded(per_cap):
    return [[tuple(getattr(c, f) for f in DECODED) for c in cells]
            for cells in per_cap]


def test_wideband_sweep_matches_jax(wide):
    """The two-cell sweep: the port's card path on the CPU against the JAX
    package's device path; the float64 route gives the same cells."""
    sig, fs_in = wide
    per_cap, deduped = wb.wideband_search_sweep(sig, fs_in, FC_CENTER, FCS,
                                                FSET, device="cpu")
    want, want_dedup = jax_wb.wideband_search_sweep(sig, fs_in, FC_CENTER,
                                                    FCS, FSET, backend="jax")
    assert [[c.n_id_cell() for c in p] for p in per_cap] == [[271], [90], []]
    assert _decoded(per_cap) == _decoded(want)
    assert max(abs(a.freq_superfine - b.freq_superfine)
               for p, q in zip(per_cap, want) for a, b in zip(p, q)) < 0.5
    assert abs(per_cap[0][0].freq_superfine - 3e3) < 50
    assert abs(per_cap[1][0].freq_superfine + 2e3) < 50
    assert sorted(c.n_id_cell() for c in deduped) == \
        sorted(c.n_id_cell() for c in want_dedup) == [90, 271]
    host, _ = wb.wideband_search_sweep(sig, fs_in, FC_CENTER, FCS, FSET,
                                       device="cpu", backend="numpy")
    assert _decoded(host) == _decoded(per_cap)
    assert max(abs(a.freq_superfine - b.freq_superfine)
               for p, q in zip(host, per_cap) for a, b in zip(p, q)) < 0.5


@pytest.fixture(scope="module")
def recordings(wide, tmp_path_factory):
    """The two-cell recording as an .it file (with its fs field) and as
    raw rtl_sdr bytes."""
    sig, fs_in = wide
    d = tmp_path_factory.mktemp("wideband")
    it_path, raw_path = str(d / "wide.it"), str(d / "wide.raw")
    save_it(it_path, {"capbuf": sig.astype(np.complex128),
                      "fc": np.array([FC_CENTER]), "fs": np.array([fs_in])})
    # Headroom so that the two-cell composite survives 8-bit quantization.
    iq_to_bytes(sig / (4 * np.abs(sig).std())).tofile(raw_path)
    return it_path, raw_path, fs_in


@pytest.mark.parametrize("form", ["it", "raw"])
def test_cli_wideband(recordings, capsys, form):
    """--wideband FILE.it (--fs-in from the file's fs field) and
    --wideband FILE.raw --wideband-rtl-sdr with --fs-in and --fc-center."""
    it_path, raw_path, fs_in = recordings
    argv = ["-s", "741e6", "-p", "10", "--device", "cpu"]
    if form == "it":
        argv += ["--wideband", it_path]
    else:
        argv += ["--wideband", raw_path, "--wideband-rtl-sdr",
                 "--fs-in", str(fs_in), "--fc-center", "739e6"]
    rc = cli.main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    assert "741 MHz: cell ID 271" in out
    assert out.splitlines()[-1].split()[0] == "271"


@pytest.mark.parametrize("drop", ["fs-in", "fc-center", "it-fs"])
def test_cli_wideband_errors_match_jax(recordings, tmp_path, drop):
    """A raw recording without --fs-in or --fc-center, and an .it file
    without an fs field and no --fs-in, exit with the JAX CLI's message."""
    it_path, raw_path, fs_in = recordings
    if drop == "it-fs":
        path = str(tmp_path / "nofs.it")
        save_it(path, {"capbuf": np.zeros(64, complex),
                       "fc": np.array([FC_CENTER])})
        argv = ["-s", "741e6", "--wideband", path]
    else:
        argv = ["-s", "741e6", "--wideband", raw_path, "--wideband-rtl-sdr"]
        argv += {"fs-in": ["--fc-center", "739e6"],
                 "fc-center": ["--fs-in", str(fs_in)]}[drop]
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    assert str(got.value).startswith("Error: --wideband")
    assert str(got.value) == str(want.value)
