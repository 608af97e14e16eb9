"""Hand-written CUDA kernels of the port: build, binding and launch counts.

Each kernel's wrapper (ops/xcorr_torch.py: ``xcorr_fold``, and
``xcorr_fold3`` for its two kernels ``xcorr_fold3`` and
``xcorr_fold3_bf16``; ops/fd_demod.py: ``fd_demod`` and
``fd_demod_stream``; models/viterbi.py) adds one to its entry in
:data:`LAUNCHES` where it launches the kernel, and nowhere else, so a run
can show that the main path went through the kernels.
"""

from __future__ import annotations

KERNELS = ("xcorr_fold", "xcorr_fold3", "xcorr_fold3_bf16", "fd_demod",
           "fd_demod_stream", "viterbi")

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
