"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from lte_cell_scanner_tpu_torch.utils.profiling import TRACER


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
