"""The sweep stack's upload (parallel/fc_sweep.py: ``device_planes``):
complex captures cast chunk by chunk into a cached complex64 staging
buffer and split into re/im planes on the device, on the CPU (where the
buffer is not pinned, so the chunk walk and the cache are what run).

Every plane is held to the float32 planes of
``np.stack([re, im], 1).astype(np.float32)`` to the bit, on values that
round to nearest-even ties, underflow, overflow and carry signed zeros
(a real (B, n) stack gets zero imaginary planes); every input that is
not a (B, n) stack keeps its conversion.
"""

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu_torch.parallel import fc_sweep
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER
from torch_one_thread import _one_torch_thread  # noqa: F401

N = 1000


@pytest.fixture
def tracer():
    """The process's tracer, on and cleared for the test, then off."""
    TRACER.reset()
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


@pytest.fixture(autouse=True)
def staging(monkeypatch):
    """An empty staging cache, and chunks of 3 captures: chunks that
    divide neither B = 5 nor B = 13."""
    cache = {}
    monkeypatch.setattr(fc_sweep, "_STAGING_CACHE", cache)
    monkeypatch.setattr(fc_sweep, "STAGE_CHUNK_BYTES", 3 * 8 * N)
    return cache


def _parts(n: int, seed: int) -> np.ndarray:
    """n float64 values, ties between float32 neighbours and edge values
    among them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    f = x.astype(np.float32)
    ties = f.astype(np.float64) + np.spacing(f).astype(np.float64) / 2
    edge = np.array([0.0, -0.0, 1e-300, -1e-300, 1e-40, 1.5e-45, 7e-46,
                     3.4e38, 3.5e38, -1e39, np.inf, -np.inf])
    x[::3] = ties[::3]
    x[:len(edge)] = edge
    return x


def _captures(b: int, dtype, seed: int = 0) -> np.ndarray:
    a = np.empty((b, N), dtype=dtype)
    with np.errstate(over="ignore"):
        a.real = _parts(b * N, seed).reshape(b, N)
        a.imag = _parts(b * N, seed + 1).reshape(b, N)
    return a


def _stacked(a: np.ndarray) -> np.ndarray:
    """The planes as the host stack converts them."""
    with np.errstate(over="ignore"):
        return np.stack([a.real, a.imag], 1).astype(np.float32)


def _same_bits(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("b", [1, 5, 13])
def test_staged_planes_equal_host_stack_bits(dtype, b):
    a = _captures(b, dtype)
    _same_bits(fc_sweep.device_planes(a, "cpu"), _stacked(a))


def test_real_captures_staged_with_zero_imaginary_planes():
    a = _captures(5, np.complex128).real.copy()
    _same_bits(fc_sweep.device_planes(a, "cpu"), _stacked(a))


@pytest.mark.parametrize("order", ["strided", "fortran"])
def test_staged_planes_of_noncontiguous_captures(order):
    a = _captures(10, np.complex128)
    x = a[::2] if order == "strided" else np.asfortranarray(a)
    _same_bits(fc_sweep.device_planes(x, "cpu"), _stacked(x))


def test_staging_buffer_reused_and_never_aliased(staging):
    """A second stack of one shape refills the cached buffer; the first
    call's planes are the device's own, not a view of the buffer."""
    a, b = _captures(5, np.complex128, 1), _captures(5, np.complex128, 7)
    first = fc_sweep.device_planes(a, "cpu")
    buf = staging[("cpu", a.shape)][0]
    second = fc_sweep.device_planes(b, "cpu")
    assert staging[("cpu", a.shape)][0] is buf and len(staging) == 1
    _same_bits(first, _stacked(a))
    _same_bits(second, _stacked(b))


def test_staging_cache_holds_two_shapes(staging):
    for b in (1, 2, 3):
        fc_sweep.device_planes(_captures(b, np.complex64), "cpu")
    assert sorted(k[1] for k in staging) == [(2, N), (3, N)]


def test_refill_waits_for_last_copy(staging, tracer):
    """A cached buffer is refilled only after the event of its last copy,
    inside the tracer's wait span."""
    a = _captures(5, np.complex128)
    fc_sweep.device_planes(a, "cpu")

    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    staging[("cpu", a.shape)][1] = Event()
    with tracer.span("sweep.stack"):
        _same_bits(fc_sweep.device_planes(a, "cpu"), _stacked(a))
    assert Event.waited == 1
    assert tracer.snapshot()["counts"]["sweep.waits"] == 1


def test_other_inputs_keep_their_conversion(staging, tracer):
    """uint8 radio planes, float planes and tensors: as converted before
    the staging, and none of them staged."""
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (4, 2, N), dtype=np.uint8)
    want_u8 = (torch.from_numpy(u8).to(torch.float32) - 127.0) / 128.0
    f64 = rng.standard_normal((4, 2, N))
    f32 = f64.astype(np.float32)
    cases = [(u8, want_u8), (f64, torch.from_numpy(f32)),
             (f32, torch.from_numpy(f32)),
             (torch.from_numpy(u8), want_u8),
             (torch.from_numpy(f64), torch.from_numpy(f32))]
    for x, want in cases:
        got = fc_sweep.device_planes(x, "cpu")
        assert got.dtype == torch.float32 and got.is_contiguous()
        _same_bits(got, want.numpy())
    assert staging == {}
    assert "sweep.staged_uploads" not in tracer.snapshot()["counts"]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_mesh_shard_stacks_equal_one_shard(dtype):
    a = _captures(10, dtype)
    mesh = fc_sweep.CapMesh(("cpu", "cpu"))
    shards = fc_sweep.shard_stacks(a, mesh.devices,
                                   fc_sweep.shard_bounds(10, 2))
    one, = fc_sweep.shard_stacks(a, (torch.device("cpu"),), [(0, 10)])
    _same_bits(torch.cat(shards), one.numpy())
    _same_bits(one, _stacked(a))


def test_staging_counters(tracer):
    """One staging allocation on a shape's first call and none on its
    second; one staged upload a shard stack."""
    a = _captures(10, np.complex128)
    devs = fc_sweep.CapMesh(("cpu", "cpu")).devices
    bounds = fc_sweep.shard_bounds(10, 2)
    fc_sweep.shard_stacks(a, devs, bounds)
    assert tracer.snapshot()["counts"] == {"sweep.staging_allocs": 1,
                                           "sweep.staged_uploads": 2}
    tracer.reset()
    fc_sweep.shard_stacks(a, devs, bounds)
    assert tracer.snapshot()["counts"] == {"sweep.staged_uploads": 2}
    tracer.reset()
    fc_sweep.device_planes(_captures(3, np.complex64), "cpu")
    assert tracer.snapshot()["counts"] == {"sweep.staging_allocs": 1,
                                           "sweep.staged_uploads": 1}
