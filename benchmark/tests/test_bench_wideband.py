"""The cell wideband20.sweep on the CPU at a tiny size (three carriers
around 739.0 MHz, ppm 10): a run is correct; with its channel taken 100
kHz off or an occupied carrier's cells dropped it is not; the whole
reference chain computed in TF32 (the control) fails a limit of
``configs/wideband20.json``; the generator's recording is the sc16 file a
surveyor's SDR writes; the channelizer's roofline reads a canned trace."""

import numpy as np
import pytest

from benchmark import check
from benchmark.control import tf32_reference
from benchmark.entries import make_entry
from benchmark.harness import run_cell
from benchmark.manifest import HERE, load_cell, load_module, reader_path
from benchmark.sim import wide
from benchmark.tests.tiny import SEED
from benchmark.trace import Spans, Window, reduce_events

CELL = "wideband20.sweep"
TINY = {"config": {"freq_start": 738.9e6, "freq_end": 739.1e6, "ppm": 10},
        "traffic": {}}


def overrides():
    return {k: dict(v) for k, v in TINY.items()}


def test_tiny_run_is_correct():
    run = run_cell(CELL, SEED, 1.0, True, device="cpu",
                   overrides=overrides())
    assert run.correct, run.checks
    assert run.attempted > 0 and run.attempted % 3 == 0
    assert run.checks["cells_differ"]["value"] == 0


def off_carrier():
    """The channel of 739.0 MHz taken at 739.1 MHz."""
    from lte_cell_scanner_tpu_torch.search import wideband

    real = wideband.channelize_batch

    def fake(wide_, fs_in, fc_center, fc_list, *args, **kwargs):
        fcs = [fc + 100e3 if fc == 739.0e6 else fc for fc in fc_list]
        return real(wide_, fs_in, fc_center, fcs, *args, **kwargs)

    return wideband, "channelize_batch", fake


def dropped():
    """The cells of 739.0 MHz left out."""
    from lte_cell_scanner_tpu_torch.search import wideband

    real = wideband.wideband_search_sweep

    def fake(wide_, fs_in, fc_center, fc_list, *args, **kwargs):
        per_cap, good = real(wide_, fs_in, fc_center, fc_list, *args,
                             **kwargs)
        return [[] if fc == 739.0e6 else cells
                for fc, cells in zip(fc_list, per_cap)], good

    return wideband, "wideband_search_sweep", fake


@pytest.mark.parametrize("fault", [off_carrier, dropped],
                         ids=["off_carrier", "dropped"])
def test_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(*fault())
    run = run_cell(CELL, SEED, 1.0, False, device="cpu",
                   overrides=overrides())
    assert not run.correct, run.checks


def test_tf32_control_fails_a_limit():
    import torch

    cell = load_cell(CELL)
    cell.config.update(TINY["config"])
    entry = make_entry(cell.config, cell.traffic, SEED, torch.device("cpu"),
                       Spans())
    entry.make_inputs()
    entry.results = {(r, b): None for r in range(len(entry.pool))
                     for b in range(len(entry.fcs))}
    pairs = []
    for key in entry.sample():
        with tf32_reference():
            control = entry.reference(key)
        pairs.append((control, entry.reference(key)))
    ok, checks = check.judge(check.compare_search(pairs),
                             cell.config["check"])
    assert not ok, checks
    assert all(len(ref) == 4 for _, ref in pairs)


def test_recording_is_sc16_and_deterministic():
    traffic = load_cell(CELL).traffic
    common = dict(traffic["site"], recording_ms=40)
    recs = []
    for seed, index in ((5, 0), (5, 0), (5, 1)):
        sites = wide.draw_sites(traffic["sites"], common, seed, index)
        recs.append(wide.wide_recording(sites, 30.72e6, 742.5e6, 40000,
                                        seed, index, 0.25))
    a, b, c = recs
    assert a.dtype == np.int16 and a.shape == (40000, 2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.abs(a).max() == 8192          # a quarter of full scale
    # Each site on its carrier: the power 100 kHz around it stands well
    # above the noise 2 MHz away.
    x = (a[:, 0] + 1j * a[:, 1]).astype(np.complex128)
    spec = np.abs(np.fft.fft(x)) ** 2
    f = np.fft.fftfreq(len(x), 1 / 30.72e6)

    def power(fc):
        return spec[np.abs(f - (fc - 742.5e6)) < 100e3].mean()

    for s in traffic["sites"]:
        assert power(s["fc"]) > 10 * power(s["fc"] + 2e6)


def test_channelizer_roofline_reader():
    """Two sweeps' convolution kernels (cuDNN's implicit GEMM and its index
    table) against the bound of two calls; other kernels not counted."""
    ch = load_module(HERE / "rooflines" / "channelizer.py")
    shapes = {"n_carriers": 271, "n_hyp": 35, "n_comb": 15, "n_cap": 153600,
              "fir_taps": 161, "n_wide": 2457760}
    flops = 2 * 153600 * 2 * 161 * 2 * 271
    nbytes = 4 * (2 * 2457760 + 2 * 271 * 2 * 161 + 2 * 271 * 153600)
    assert ch.flops(153600, 161, 271) == flops
    assert ch.nbytes(2457760, 153600, 161, 271) == nbytes
    bound = max(flops / 67e12, nbytes / 3.35e12)
    conv = "void precomputed_convolve_sgemm<float, 128, 6, 7>(int, int)"
    idx = "void cudnn::cnn::kern_precompute_indices<false>(int*, int)"
    events = [(conv, True, 0.0, 2000.0), (idx, True, 2000.0, 2001.0),
              (conv, True, 5000.0, 7000.0), (idx, True, 7000.0, 7001.0),
              ("xcorr_fold_tc_kernel(float const*)", True, 3000.0, 4000.0)]
    win = Window(units={}, traced_units={"sweeps": 2}, spans={},
                 trace=reduce_events(events, window_s=1e-2), shapes=shapes)
    read = load_module(reader_path("wideband.channelizer_roofline")).read
    assert read(win) == pytest.approx(100 * 2 * bound / 4002e-6)
