"""PyTorch port of the fused symbol demod (lte_cell_scanner_tpu_torch/
ops/fd_demod.py, plain version on the CPU) vs the JAX Pallas kernel K4 in
its MIB mode (pre_bpo=True, the _dft72 matrices) in interpret mode.
"""

import numpy as np
import jax.numpy as jnp
import torch

from lte_cell_scanner_tpu.ops.fd_demod_pallas import (fd_demod_pallas,
                                                      planar_rows_f32)
from lte_cell_scanner_tpu.ops.mib_jax import _dft72 as jax_dft72
from lte_cell_scanner_tpu.ops.tfg import CN as JAX_CN
from lte_cell_scanner_tpu_torch.ops.fd_demod import fd_demod
from lte_cell_scanner_tpu_torch.ops.mib_torch import _dft72
from lte_cell_scanner_tpu_torch.ops.tfg import CN


def test_tables_match_jax():
    for a, b in zip(_dft72(), jax_dft72()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(CN, JAX_CN)


def test_fd_demod_matches_pallas():
    rng = np.random.default_rng(0)
    n_cap = 128 * 60 + 37                  # not a multiple of 128: zero pad
    cap = rng.standard_normal((n_cap, 2)).astype(np.float32)
    n = 300
    idx = rng.integers(0, n_cap - 128, n).astype(np.int32)
    # Row-straddling, first and last windows (the last ones read the pad
    # and the clamped row).
    idx[:6] = [0, 1, 127, 128, n_cap - 128, n_cap - 1]
    foc = rng.uniform(-0.05, 0.05, n).astype(np.float32)
    bpo = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    late = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    wr, wi = _dft72()
    cn = CN.astype(np.float32)

    t = torch.from_numpy
    got = fd_demod(t(cap), t(idx), t(foc), t(bpo), t(late), t(wr), t(wi),
                   t(cn)).numpy()
    ra, ia, ra1, ia1, bofs = planar_rows_f32(jnp.asarray(cap),
                                             jnp.asarray(idx))
    want = np.asarray(fd_demod_pallas(
        ra, ia, ra1, ia1, bofs, jnp.asarray(foc), jnp.asarray(bpo),
        jnp.asarray(late), mats=(wr, wi, cn), pre_bpo=True, interpret=True))
    assert got.shape == want.shape == (n, 72, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
