"""Host-to-device copies through ``utils/device.py``'s two pinned
buffers (:class:`PinnedStaging`), on the CPU, where the buffers are not
pinned, so that the turns, the growth and the chunk walk are what run:
the class alone, and the capture upload ``device_planes``, which casts
complex captures chunk by chunk into a buffer of the device's one capture
staging and splits them into re/im planes on the device, for the sweep
stack and for ``cell_search``.

Every plane is held to the float32 planes of
``np.stack([re, im], 1).astype(np.float32)`` to the bit, on values that
round to nearest-even ties, underflow, overflow and carry signed zeros
(a real (B, n) stack gets zero imaginary planes); every input that is
not a (B, n) stack keeps its conversion.
"""

import importlib

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu_torch.io.simulator import synthetic_capture
from lte_cell_scanner_tpu_torch.parallel import fc_sweep
from lte_cell_scanner_tpu_torch.utils import device
from lte_cell_scanner_tpu_torch.utils.device import (PinnedStaging,
                                                     device_planes,
                                                     flat_stack)
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER
from torch_one_thread import _one_torch_thread  # noqa: F401

N = 1000
CPU = torch.device("cpu")


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
    """No capture staging yet on any device, and chunks of 3 captures:
    chunks that divide neither B = 5 nor B = 13."""
    per_device = {}
    monkeypatch.setattr(device, "_CAPTURE_STAGING", per_device)
    monkeypatch.setattr(device, "STAGE_CHUNK_BYTES", 3 * 8 * N)
    return per_device


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
    """The planes, and the contiguous (B n, 2) stack the decode reads."""
    a = _captures(b, dtype)
    planes = device_planes(a, "cpu")
    _same_bits(planes, _stacked(a))
    flat = flat_stack(planes)
    assert flat.is_contiguous()
    _same_bits(flat, _stacked(a).transpose(0, 2, 1).reshape(-1, 2))


def test_real_captures_staged_with_zero_imaginary_planes():
    a = _captures(5, np.complex128).real.copy()
    _same_bits(device_planes(a, "cpu"), _stacked(a))


@pytest.mark.parametrize("order", ["strided", "fortran"])
def test_staged_planes_of_noncontiguous_captures(order):
    a = _captures(10, np.complex128)
    x = a[::2] if order == "strided" else np.asfortranarray(a)
    _same_bits(device_planes(x, "cpu"), _stacked(x))


@pytest.mark.parametrize("sizes", [(64, 64, 64, 64),
                                   (64, 128, 192, 64, 256)],
                         ids=["steady", "growing"])
def test_pinned_staging_turns_and_growth(sizes, tracer):
    """Two buffers handed out in turn, never one twice in a row; a buffer
    reallocated (and counted) only when a request exceeds it, then holding
    exactly that request; plain memory on the CPU."""
    st = PinnedStaging(CPU, "test.allocs")
    got = []
    for n in sizes:
        got.append(st.take(n))
        st.sent()
    held, allocs = [0, 0], 0
    for i, (buf, n) in enumerate(zip(got, sizes)):
        assert buf.dtype == torch.uint8 and not buf.is_pinned()
        if i:
            assert buf is not got[i - 1]
        if held[i % 2] < n:
            held[i % 2], allocs = n, allocs + 1
            assert i < 2 or buf is not got[i - 2]
        else:
            assert buf is got[i - 2]
        assert buf.numel() == held[i % 2]
    assert tracer.snapshot()["counts"] == {"test.allocs": allocs}


def test_staging_buffer_reused_and_never_aliased(staging):
    """A third stack of one shape refills the first call's buffer; every
    call's planes are the device's own, not a view of a buffer."""
    a, b, c = (_captures(5, np.complex128, s) for s in (1, 7, 9))
    first = device_planes(a, "cpu")
    buf = staging[CPU].bufs[0]
    second = device_planes(b, "cpu")
    third = device_planes(c, "cpu")
    assert staging[CPU].bufs[0] is buf and len(staging) == 1
    _same_bits(first, _stacked(a))
    _same_bits(second, _stacked(b))
    _same_bits(third, _stacked(c))


def test_staging_cache_holds_two_shapes(staging):
    """One capture staging a device, its two buffers taken in turn, each
    grown only to the largest stack it carried."""
    for b in (1, 2, 3):
        device_planes(_captures(b, np.complex64), "cpu")
    assert list(staging) == [CPU]
    assert [buf.numel() for buf in staging[CPU].bufs] == [3 * 8 * N,
                                                          2 * 8 * N]


@pytest.mark.parametrize("in_flight", [True, False],
                         ids=["in_flight", "done"])
def test_refill_waits_for_last_copy(staging, tracer, in_flight):
    """A buffer is refilled only after the event of its last copy: a wait
    inside the tracer's wait span while that copy is in flight, none (and
    no count) once it has run."""
    a = _captures(5, np.complex128)
    device_planes(a, "cpu")
    device_planes(a, "cpu")

    class Event:
        waited = 0

        def query(self):
            return not in_flight

        def synchronize(self):
            Event.waited += 1

    staging[CPU].events[0] = Event()
    with tracer.span("sweep.stack"):
        _same_bits(device_planes(a, "cpu"), _stacked(a))
    assert Event.waited == int(in_flight)
    assert tracer.snapshot()["counts"].get("sweep.waits", 0) == int(
        in_flight)


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
        got = device_planes(x, "cpu")
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
    """Two shards on one device take its two buffers in turn: two
    allocations on the first call, none on the second, one staged upload
    a shard stack; a smaller stack fits, a larger one grows a buffer."""
    a = _captures(10, np.complex128)
    devs = fc_sweep.CapMesh(("cpu", "cpu")).devices
    bounds = fc_sweep.shard_bounds(10, 2)
    fc_sweep.shard_stacks(a, devs, bounds)
    assert tracer.snapshot()["counts"] == {"sweep.staging_allocs": 2,
                                           "sweep.staged_uploads": 2}
    tracer.reset()
    fc_sweep.shard_stacks(a, devs, bounds)
    assert tracer.snapshot()["counts"] == {"sweep.staged_uploads": 2}
    tracer.reset()
    device_planes(_captures(3, np.complex64), "cpu")
    assert tracer.snapshot()["counts"] == {"sweep.staged_uploads": 1}
    tracer.reset()
    device_planes(_captures(6, np.complex64), "cpu")
    assert tracer.snapshot()["counts"] == {"sweep.staging_allocs": 1,
                                           "sweep.staged_uploads": 1}


def test_cell_search_takes_one_staged_upload(tracer, monkeypatch):
    """``cell_search`` uploads its capture through the staging, once a
    search, and finds the cells of the host-stacked planes it uploaded
    before, to the bit: those of test_torch_cell_search.py's first JAX
    comparison."""
    cs = importlib.import_module(
        "lte_cell_scanner_tpu_torch.search.cell_search")
    cap = synthetic_capture(n_id_1=90, n_id_2=1, cp_type="normal",
                            snr_db=10, freq_offset=7.7e3, n_rb_dl=50,
                            sfn_start=64, seed=3)
    fset = np.arange(-3, 4) * 5e3
    got = cs.cell_search(cap, 739e6, f_search_set=fset, device="cpu")
    assert tracer.snapshot()["counts"]["sweep.staged_uploads"] == 1
    monkeypatch.setattr(cs, "device_planes", lambda a, dev: torch.from_numpy(
        _stacked(np.asarray(a, dtype=np.complex128))).to(dev))
    want = cs.cell_search(cap, 739e6, f_search_set=fset, device="cpu")
    assert [c.n_id_cell() for c in got] == [271]
    assert [repr(c) for c in got] == [repr(c) for c in want]
