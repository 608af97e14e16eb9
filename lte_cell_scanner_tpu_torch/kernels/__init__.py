"""Hand-written CUDA kernels of the port: build, binding and launch counts.

Each kernel's wrapper (ops/xcorr_torch.py: ``xcorr_fold``, and
``xcorr_fold3`` for its two kernels ``xcorr_fold3`` and
``xcorr_fold3_bf16``; ops/fd_demod.py: ``fd_demod`` and
``fd_demod_stream``; models/viterbi.py; ops/peak_torch.py:
``peak_greedy``) adds one to its entry in :data:`LAUNCHES` where it
launches the kernel, so a run can show that the main path went through
the kernels. The tracker engine's CUDA graphs
(tracker/batch_runtime.py) take back what their capture counted and add
it at each replay, which launches the kernels.
"""

from __future__ import annotations

KERNELS = ("xcorr_fold", "xcorr_fold3", "xcorr_fold3_bf16", "fd_demod",
           "fd_demod_stream", "viterbi", "peak_greedy")

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
