"""PyTorch port of the batched MIB chain (lte_cell_scanner_tpu_torch/
ops/mib_torch.py) vs the JAX device program (ops/mib_jax.py), stage by
stage: the same JAX plan goes to ``_build_mib_device(stage=s,
stage_raw=True)`` and to the port's ``run(stages=...)``. Both CP geometries
and both channel-estimate interpolators; the port's tables and planner
must equal the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lte_cell_scanner_tpu.constants import DS_COMB_ARM, THRESH2_N_SIGMA
from lte_cell_scanner_tpu.ops import mib_jax
from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.ops import mib_torch
from lte_cell_scanner_tpu_torch.ops.peak_torch import (peak_search_device,
                                                       peaks_to_cells,
                                                       r_th1_normalized)
from lte_cell_scanner_tpu_torch.ops.sync_torch import sss_foe_batch
from lte_cell_scanner_tpu_torch.ops.xcorr_torch import scan_plan, xcorr_core
from torch_one_thread import _one_torch_thread  # noqa: F401


FC = 739e6
CAPTURES = {
    "normal": dict(n_id_1=90, n_id_2=1, cp_type="normal", snr_db=10.0,
                   freq_offset=7.7e3, n_rb_dl=50, sfn_start=64, seed=3),
    "extended": dict(n_id_1=30, n_id_2=2, cp_type="extended", snr_db=20.0,
                     freq_offset=2e3, n_rb_dl=25, seed=3),
}


@pytest.fixture(scope="module", params=["normal", "extended"])
def candidates(request):
    """(cap (n, 2) f32, the synced candidates of the capture's CP type)."""
    cp = request.param
    cap = synthetic_capture(**CAPTURES[cp])
    fset = np.arange(-2, 3) * 5e3
    cap32 = np.stack([cap.real, cap.imag], -1).astype(np.float32)
    cap_t = torch.from_numpy(cap32)
    plan = scan_plan(len(cap), fset, FC, FC, 1.92e6)
    packed, single, _ = xcorr_core(cap_t.T.contiguous(), plan, DS_COMB_ARM)
    peaks = peaks_to_cells(peak_search_device(
        packed, single, r_th1_normalized(plan.n_comb_xc, DS_COMB_ARM),
        DS_COMB_ARM).numpy(), fset, FC, FC)
    alive = [c for c in sss_foe_batch(peaks, cap_t, THRESH2_N_SIGMA)
             if c.n_id_1 >= 0 and c.cp_type == cp]
    assert alive
    return cap32, alive


def _tl_to_dllr(llr_tl):
    """The port's time-major (120, B, 4, 3) LLRs -> JAX's (B, 4, 3, 3, 40)."""
    B = llr_tl.shape[1]
    x = llr_tl.reshape(10, 4, 3, B, 4, 3)       # chunk, ti, code, b, g, p
    return np.transpose(x, (3, 4, 5, 2, 0, 1)).reshape(B, 4, 3, 3, 40)


def _close(got, want, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * scale, f"{name}: max err {err} vs max {scale}"


@pytest.mark.parametrize("interp", ["hex", "freq_time"])
def test_mib_stages_match_jax(candidates, interp):
    cap32, cells = candidates
    n = len(cells)
    cp = cells[0].cp_type
    plan = mib_jax.mib_plan(cells, len(cap32), FC, FC, 1.92e6)
    u8, f32 = mib_jax._pack_plan(plan)
    tabs = mib_jax._dev_cell_tables(cp)

    stages = {}
    out = mib_torch.run(torch.from_numpy(cap32), plan, interp, stages=stages)
    assert set(stages) == set(mib_torch.MIB_STAGES)
    # Every stage where the two CP geometries and interpolators meet;
    # the interpolator-independent front stages once per CP type.
    names = mib_torch.MIB_STAGES if interp == "hex" else (
        "chanest", "llr", "vit")
    for s in names:
        run = mib_jax._build_mib_device(plan.n_symb_dl, plan.n_ofdm,
                                        plan.m_bit, stage=s, stage_raw=True,
                                        interp=interp)
        want = run(jnp.asarray(cap32), u8, f32, *tabs)
        got = stages[s]
        if s == "vit":
            np.testing.assert_array_equal(got.numpy()[:n],
                                          np.asarray(want)[:n])
            continue
        if s == "llr":
            got = _tl_to_dllr(got.numpy())
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(np.asarray(g)[:n], np.asarray(w)[:n], f"{s}[{i}]")

    full = mib_jax._mib_device(plan.n_symb_dl, plan.n_ofdm, plan.m_bit,
                               interp=interp)
    ref = mib_jax.finish_mib_batch(mib_jax.MibPending(
        full(jnp.asarray(cap32), u8, f32, *tabs), plan, cells))
    got = mib_torch.finish_mib_batch(mib_torch.MibPending(out, plan))[:n]
    for g, r in zip(got, ref):
        assert (g.n_rb_dl, g.n_ports, g.sfn, g.phich_duration,
                g.phich_resource) == (r.n_rb_dl, r.n_ports, r.sfn,
                                      r.phich_duration, r.phich_resource)
        assert abs(g.freq_superfine - r.freq_superfine) < 0.5
    cfg = CAPTURES[cp]
    assert any(c.n_id_cell() == 3 * cfg["n_id_1"] + cfg["n_id_2"]
               and c.n_rb_dl == cfg["n_rb_dl"] for c in got)


def test_mib_plan_matches_jax(candidates):
    cap32, cells = candidates
    mine = mib_torch.mib_plan(cells, len(cap32))
    ref = mib_jax.mib_plan(cells, len(cap32), FC, FC, 1.92e6, bucket=False)
    for f in dataclasses.fields(ref):
        if f.name != "cells":
            np.testing.assert_array_equal(getattr(mine, f.name),
                                          getattr(ref, f.name),
                                          err_msg=f.name)


@pytest.mark.parametrize("cp_type", ["normal", "extended"])
def test_tables_match_jax(cp_type):
    n_symb_dl = 7 if cp_type == "normal" else 6
    n_ofdm = 6 * 10 * 2 * n_symb_dl + 2 * n_symb_dl
    m_bit = 1920 if cp_type == "normal" else 1728
    pairs = [
        (mib_torch._deratematch_mat(m_bit), mib_jax._deratematch_mat(m_bit)),
        (mib_torch._crc16_mat(), mib_jax._crc16_mat()),
        (mib_torch._pbch_sel(n_symb_dl), mib_jax._pbch_sel(n_symb_dl)),
        (mib_torch._freq_interp_mats(), mib_jax._freq_interp_mats()),
        (mib_torch._crc_masks(), mib_jax._crc_masks()),
        *zip(mib_torch._filter_mats12(), mib_jax._filter_mats12()),
        *zip(mib_torch._all_cell_tables(cp_type),
             mib_jax._all_cell_tables(cp_type)),
    ]
    rows_sel = mib_torch._rows_sel(n_symb_dl)
    for pc in (0, 1):
        pairs.append((mib_torch._time_interp_mat(n_symb_dl, n_ofdm, pc),
                      mib_jax._time_interp_mat(n_symb_dl, n_ofdm, pc)))
        pairs.extend(zip(
            mib_torch._hex_interp_tabs(n_symb_dl, n_ofdm, rows_sel, pc),
            mib_jax._hex_interp_tabs(n_symb_dl, n_ofdm, rows_sel, pc)))
    for i, (a, b) in enumerate(pairs):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


def test_extract_tfg_batch_matches_jax(candidates):
    """The full 854/732-row device grid (K4's MIB mode over every row)
    against the JAX package's extract_tfg_batch on the CPU (rtol 1e-5 +
    atol 1e-5 * max: float32 products in another order) and against the
    float64 host extract_tfg (timestamps within 1e-9, the grid within
    2e-3 * max: the bound of tests/test_device_decode.py::
    test_device_full_tfg_matches_host). A cell whose grid passes the
    capture's end gets ok False."""
    from lte_cell_scanner_tpu_torch.ops.tfg import extract_tfg

    cap32, cells = candidates
    cap = cap32[:, 0].astype(np.float64) + 1j * cap32[:, 1]
    tfg, ts, ok = mib_torch.extract_tfg_batch(cells, torch.from_numpy(cap32))
    n_ofdm = 854 if cells[0].cp_type == "normal" else 732
    assert tfg.shape == (len(cells), n_ofdm, 72)
    assert tfg.dtype == np.complex64 and ok.all()
    jtfg, jts, jok = mib_jax.extract_tfg_batch(cells, cap, FC, FC, 1.92e6)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_allclose(tfg, jtfg, rtol=1e-5,
                               atol=1e-5 * np.abs(jtfg).max())
    for b, c in enumerate(cells):
        tfg_h, ts_h = extract_tfg(c, cap, FC, FC, 1.92e6)
        np.testing.assert_allclose(ts[b], ts_h, rtol=0, atol=1e-9)
        np.testing.assert_allclose(tfg[b], tfg_h, rtol=0,
                                   atol=2e-3 * np.abs(tfg_h).max())
    short = mib_torch.extract_tfg_batch(cells,
                                        torch.from_numpy(cap32[:100000]))
    assert short[0].shape == tfg.shape and not short[2].any()
