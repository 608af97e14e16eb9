"""Device selection for the port's entry points, and every copy of host
data to a device and back: :func:`upload`, :func:`to_host`,
:class:`HostFetch`, and the two host buffers of :class:`PinnedStaging`
that the tracker engine's plans and the captures of :func:`device_planes`
pass through."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

# Bytes of complex64 a staged capture upload converts and copies at a
# time: the card copies one chunk while the host converts the next.
STAGE_CHUNK_BYTES = 16 << 20
# device -> the PinnedStaging of its capture uploads
_CAPTURE_STAGING: Dict[torch.device, "PinnedStaging"] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is asked for and
    absent: the entry points never fall back to the CPU on their own; a
    caller that wants the plain PyTorch versions passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions of the kernels")
    return dev


def full_f32_matmuls() -> None:
    """Run float32 matrix products and convolutions in full float32.

    TF32 keeps ~10 mantissa bits and flips near-tie argmaxes of the
    168-hypothesis SSS scan; the JAX reference is full f32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def launch_device(dev: torch.device):
    """A context that makes ``dev`` the CUDA runtime's current device for a
    C launcher (which launches on the current device): ``torch.cuda.device``
    when another device is current, else a no-op, so that a launch on the
    current card pays no device switch."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def upload(a: np.ndarray, dev: torch.device,
           non_blocking: bool = False) -> torch.Tensor:
    """A host array on ``dev``. ``non_blocking`` stages it in pinned
    memory and copies it without waiting for the stream, so that the host
    runs ahead of the card (a pipelined sweep); otherwise the copy waits
    for the stream, as a plain ``.to(dev)`` does."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if non_blocking and dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array: on the card a blocking copy, the host
    waiting for the stream inside the tracer's ``wait`` span."""
    with TRACER.wait():
        return t.cpu().numpy()


class HostFetch:
    """Tensors on their way to the host.

    On the card each tensor is copied into pinned host memory with
    ``non_blocking=True`` on the current stream, and an event is recorded
    after the copies: the host goes on until :meth:`wait`, which waits for
    that event only, inside the tracer's ``wait`` span. CPU tensors are
    held as they are. :meth:`wait` returns a dict of numpy arrays under
    the same keys.
    """

    def __init__(self, tensors: dict):
        self.event = None
        self.host = {}
        dev = None
        for k, t in tensors.items():
            if t.device.type == "cuda":
                dev = t.device
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self.host[k] = h.copy_(t, non_blocking=True)
            else:
                self.host[k] = t
        if dev is not None:
            # The copies run on the source device's current stream.
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def wait(self) -> dict:
        with TRACER.wait():
            if self.event is not None:
                self.event.synchronize()
            return {k: v.numpy() for k, v in self.host.items()}


class PinnedStaging:
    """Two host buffers for copies to ``device``, handed out in turn.

    :meth:`take` hands out the next buffer; :meth:`sent` says that the
    copies out of it are enqueued, and on a card records an event after
    them. A buffer is handed out again only once that event has completed:
    :meth:`take` queries it and waits, inside the tracer's ``wait`` span,
    only while the copy is still in flight. On a card the buffers are
    pinned, so that those copies need not block; on the CPU they are plain
    memory and a copy has run when it returns. A buffer is reallocated
    only when a request exceeds it (counted as ``alloc_counter``, if
    given).
    """

    def __init__(self, device: torch.device,
                 alloc_counter: Optional[str] = None):
        self.device = device
        self.alloc_counter = alloc_counter
        self.bufs = [None, None]
        self.events = [None, None]
        self.turn = 1

    def take(self, nbytes: int) -> torch.Tensor:
        """The next buffer: a uint8 host tensor of at least ``nbytes``."""
        self.turn ^= 1
        ev = self.events[self.turn]
        if ev is not None and not ev.query():
            with TRACER.wait():
                ev.synchronize()
        buf = self.bufs[self.turn]
        if buf is None or buf.numel() < nbytes:
            if self.alloc_counter is not None:
                TRACER.count(self.alloc_counter)
            buf = self.bufs[self.turn] = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return buf

    def sent(self) -> None:
        """The copies out of the buffer :meth:`take` last handed out are
        enqueued on the device's current stream."""
        if self.device.type == "cuda":
            ev = self.events[self.turn] = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))


def _capture_staging(dev: torch.device) -> PinnedStaging:
    """The device's one staging for capture uploads (allocations counted
    as ``sweep.staging_allocs``)."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    staging = _CAPTURE_STAGING.get(dev)
    if staging is None:
        staging = _CAPTURE_STAGING[dev] = PinnedStaging(
            dev, "sweep.staging_allocs")
    return staging


def _staged_planes(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Complex (or real) (B, n) -> (B, 2, n) float32 planes on ``dev``:
    each chunk of :data:`STAGE_CHUNK_BYTES` cast to complex64 into a
    buffer of the device's capture staging (each part rounded to the
    nearest float32, as ``astype`` does), then copied to the device
    without waiting, so that the copy of one chunk overlaps the cast of
    the next; split into re/im planes on ``dev``.

    A stack of captures is cast by torch's thread pool. A lone capture
    (``cell_search``'s) is cast by numpy on the calling thread: the
    pool's threads keep spinning after a cast and slow the host work of
    the search that follows more than the pool saves on one capture."""
    a = np.ascontiguousarray(a)
    staging = _capture_staging(dev)
    nbytes = 8 * a.size
    stage = staging.take(nbytes)[:nbytes].view(torch.complex64).view(
        a.shape)
    out = torch.empty(a.shape, dtype=torch.complex64, device=dev)
    rows = max(1, STAGE_CHUNK_BYTES // (8 * a.shape[1]))
    for lo in range(0, len(a), rows):
        if len(a) == 1:
            with np.errstate(over="ignore"):    # as torch's cast: inf
                np.copyto(stage.numpy(), a)
        else:
            stage[lo:lo + rows].copy_(torch.from_numpy(a[lo:lo + rows]))
        out[lo:lo + rows].copy_(stage[lo:lo + rows], non_blocking=True)
    staging.sent()
    TRACER.count("sweep.staged_uploads")
    return torch.view_as_real(out).permute(0, 2, 1).contiguous()


def device_planes(capbufs, dev: torch.device,
                  non_blocking: bool = False) -> torch.Tensor:
    """(B, 2, n) float32 re/im planes on ``dev`` from complex (B, n)
    (through the device's capture staging, :func:`_staged_planes`), uint8
    radio planes (B, 2, n) (converted on the device as (x - 127) / 128),
    float planes, or a tensor of either."""
    if isinstance(capbufs, torch.Tensor):
        x = capbufs.to(dev, non_blocking=non_blocking)
    else:
        a = np.asarray(capbufs)
        if a.ndim == 2:
            return _staged_planes(a, torch.device(dev))
        x = upload(a, dev, non_blocking)
    if x.dtype == torch.uint8:
        return (x.to(torch.float32) - 127.0) / 128.0
    return x.to(torch.float32).contiguous()


def flat_stack(cap: torch.Tensor) -> torch.Tensor:
    """(B, 2, n) planes -> the contiguous (B n, 2) stack the decode
    programs read (at B = 1 the reshape alone is a strided view)."""
    return cap.transpose(1, 2).reshape(-1, 2).contiguous()
