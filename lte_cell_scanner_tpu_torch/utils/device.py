"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


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
