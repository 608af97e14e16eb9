"""The port's batched tracker math (lte_cell_scanner_tpu_torch/tracker/
batch_frontend.py) and the stream mode of the symbol demod (ops/fd_demod.py
fd_demod_stream, plain version on the CPU) vs the JAX package: the same
seeded float32 inputs through both.

Tolerances: float32 functions agree within rtol 1e-5 + atol 1e-5 * max
(the two frameworks sum matrix products in different orders); the tables
and the float64 host planners are built by the same numpy code and agree
exactly; the demod stream mode agrees with the Pallas kernel K4 in
interpret mode within 1e-4 * max, as the MIB mode does
(tests/test_torch_fd_demod.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lte_cell_scanner_tpu.ops.fd_demod_pallas import (fd_demod_pallas,
                                                      planar_rows)
from lte_cell_scanner_tpu.tracker import batch_frontend as jbf
from lte_cell_scanner_tpu_torch.ops.fd_demod import (fd_demod_stream,
                                                     fd_demod_stream_plain)
from lte_cell_scanner_tpu_torch.tracker import batch_frontend as bf
from torch_one_thread import _one_torch_thread  # noqa: F401

RNG_SEED = 7


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def _ce(rng, *shape):
    return rng.standard_normal(shape + (12, 2)).astype(np.float32)


# The tracker's DFT matrices are those of its named DFT, TRACKER_DFT.
_TABLES = {"_dft_mats": lambda: bf.dft_mats(bf.TRACKER_DFT),
           "_filter_mats": bf._filter_mats, "_smooth62": bf._smooth62}


@pytest.mark.parametrize("name", ["_dft_mats", "_filter_mats", "_smooth62"])
def test_tables_match_jax(name):
    got, want = _TABLES[name](), getattr(jbf, name)()
    if isinstance(want, np.ndarray):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(bf.dft_cn(bf.TRACKER_DFT),
                                  jbf._CN.astype(np.float32))
    np.testing.assert_array_equal(bf._BINS, jbf._BINS)


def test_bulk_phase_offsets_exact():
    rng = np.random.default_rng(RNG_SEED)
    bpo0 = rng.uniform(-np.pi, np.pi, 5)
    fo = rng.uniform(-9e3, 9e3, (5, 300))
    n_samp = rng.choice([137.0, 138.0, 160.0], (5, 300))
    got = bf.bulk_phase_offsets(bpo0, fo, n_samp)
    want = jbf.bulk_phase_offsets(bpo0, fo, n_samp)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aligned", [False, True])
def test_get_fd_batch_matches_jax(aligned):
    rng = np.random.default_rng(RNG_SEED)
    data = rng.standard_normal((3, 50, 128, 2)).astype(np.float32)
    foc = rng.normal(scale=1e-3, size=(3, 50)).astype(np.float32)
    bpo = rng.uniform(-np.pi, np.pi, (3, 50)).astype(np.float32)
    late = rng.uniform(-130, 2, (3, 50)).astype(np.float32)
    j = None
    if aligned:
        b = rng.integers(0, 128, (3, 50))
        c = np.arange(128)
        j = (c - b[..., None] + np.where(c >= b[..., None], 0, 128)
             ).astype(np.float32)
    t = torch.from_numpy
    got = bf.get_fd_batch(t(data), t(foc), t(bpo), t(late),
                          j=None if j is None else t(j))
    want = jbf.get_fd_batch(jnp.asarray(data), jnp.asarray(foc),
                            jnp.asarray(bpo), jnp.asarray(late),
                            j=None if j is None else jnp.asarray(j))
    _close(got, want)


def test_raw_ce_batch_matches_jax():
    rng = np.random.default_rng(RNG_SEED)
    syms = rng.standard_normal((2, 9, 1, 72, 2)).astype(np.float32)
    rs_conj = _ce(rng, 2, 9, 1)
    shift = rng.integers(0, 6, (2, 9, 4)).astype(np.int32)
    got = bf.raw_ce_batch(torch.from_numpy(syms), torch.from_numpy(rs_conj),
                          torch.from_numpy(shift))
    want = jbf.raw_ce_batch(jnp.asarray(syms), jnp.asarray(rs_conj),
                            jnp.asarray(shift))
    _close(got, want)


def test_ce_statistics_match_jax():
    """filter_ce_batch, foe_stats_batch, toe_stats_batch and ac_fd_batch
    on one set of RS triples."""
    rng = np.random.default_rng(RNG_SEED)
    base = _ce(rng, 40)
    cp, cc, cn = (base + 0.3 * _ce(rng, 40) for _ in range(3))
    pl = rng.integers(0, 2, 40).astype(bool)
    t = torch.from_numpy
    got_f = bf.filter_ce_batch(t(cp), t(cc), t(cn), t(pl))
    want_f = jbf.filter_ce_batch(*(jnp.asarray(a) for a in (cp, cc, cn, pl)))
    for g, w in zip(got_f, want_f):
        _close(g, w)
    ce_filt, np_c, _, sp_c, _ = (np.array(w) for w in want_f)
    pairs = [
        (bf.foe_stats_batch(t(cp), t(cn), t(ce_filt), t(np_c)),
         jbf.foe_stats_batch(cp, cn, ce_filt, np_c)),
        (bf.toe_stats_batch(t(cp), t(cc), t(sp_c), t(np_c), t(pl)),
         jbf.toe_stats_batch(cp, cc, sp_c, np_c, pl)),
        (bf.ac_fd_batch(t(cc), t(sp_c), t(np_c)),
         jbf.ac_fd_batch(cc, sp_c, np_c)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            _close(g, w)


def test_sync_meas_batch_matches_jax():
    rng = np.random.default_rng(RNG_SEED)
    pss = rng.standard_normal((3, 4, 72, 2)).astype(np.float32)
    sss = rng.standard_normal((3, 4, 72, 2)).astype(np.float32)
    pss_conj = rng.standard_normal((3, 1, 62, 2)).astype(np.float32)
    sss_seq = rng.choice([-1.0, 1.0], (3, 4, 62)).astype(np.float32)
    got = bf.sync_meas_batch(*(torch.from_numpy(a)
                               for a in (pss, sss, pss_conj, sss_seq)))
    want = jbf.sync_meas_batch(*(jnp.asarray(a)
                                 for a in (pss, sss, pss_conj, sss_seq)))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


def test_fd_demod_stream_matches_pallas():
    """Stream mode vs the Pallas kernel K4 (u8 rows, pre_bpo=False, the
    tracker's DFT tables) in interpret mode, including row-straddling,
    first-row and last-row windows and windows reading the 127 pad."""
    rng = np.random.default_rng(RNG_SEED)
    L = 128 * 40 + 77                      # not a multiple of 128: pad
    seg = rng.integers(0, 256, (L, 2), dtype=np.uint8)
    n = 300
    starts = rng.integers(0, L - 128, n).astype(np.int32)
    starts[:7] = [0, 1, 127, 128, 255, L - 128, L - 1]
    foc = rng.normal(scale=1e-3, size=n).astype(np.float32)
    bpo = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    late = rng.uniform(-2, 2, n).astype(np.float32)
    t = torch.from_numpy
    got = fd_demod_stream(t(seg), t(starts), t(foc), t(bpo), t(late))
    want = fd_demod_pallas(*planar_rows(jnp.asarray(seg), jnp.asarray(starts)),
                           jnp.asarray(foc), jnp.asarray(bpo),
                           jnp.asarray(late), pre_bpo=False, interpret=True)
    assert got.shape == (n, 72, 2)
    _close(got, want, rtol=0, atol_rel=1e-4)
    # On the CPU the wrapper is its plain version.
    torch.testing.assert_close(
        got, fd_demod_stream_plain(t(seg), t(starts), t(foc), t(bpo),
                                   t(late)), rtol=0, atol=0)
