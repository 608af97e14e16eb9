"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<source>.cu`` exports one ``extern "C"`` launcher per kernel
(``xcorr_fold.cu`` three: the 2x2 kernel and the float32 and bfloat16
modes of the Karatsuba kernel; ``fd_demod.cu`` two: the MIB and the
stream mode) that takes raw device pointers and a CUDA stream and returns
``cudaGetLastError()``. A source is compiled for Hopper (``sm_90a``) into
a shared library under ``build/kernels/`` at the root of the checkout,
named by a hash of its source so that an edited source is rebuilt.
Nothing is built or loaded at import time: the first launch builds what
it needs, and :func:`build` compiles several sources at once, one nvcc
process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

from lte_cell_scanner_tpu_torch.kernels import KERNELS

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_XCORR_ARGS = (_P, _I, _P, _P, _I, _I, _P, _P)
_XCORR_BATCH_ARGS = (_P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P)
_FD_DEMOD_ARGS = (_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P)
# Source, launcher name and argument types of each kernel's C interface.
_SIGNATURES = {
    "xcorr_fold": ("xcorr_fold", "xcorr_fold_launch", _XCORR_BATCH_ARGS),
    "xcorr_fold3": ("xcorr_fold", "xcorr_fold3_launch", _XCORR_ARGS),
    "xcorr_fold3_bf16": ("xcorr_fold", "xcorr_fold3_bf16_launch",
                         _XCORR_ARGS),
    "fd_demod": ("fd_demod", "fd_demod_launch", _FD_DEMOD_ARGS),
    "fd_demod_stream": ("fd_demod", "fd_demod_stream_launch", _FD_DEMOD_ARGS),
    "viterbi": ("viterbi", "viterbi_launch", (_P, _I, _I, _P, _P, _P, _P)),
}

_LIBS: Dict[str, ctypes.CDLL] = {}     # by source
_FNS: Dict[str, Callable[..., int]] = {}  # by kernel


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(source: str) -> Path:
    src = CSRC / f"{source}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{source}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile the sources of the named kernels that are not built yet,
    all at once.

    Returns, per source, the wall seconds its build took and nvcc's output
    (ptxas' register and shared-memory report), or (0.0, "") for a library
    that was already there; raises RuntimeError with nvcc's output on a
    failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Tuple[float, str]] = {}
    procs = {}
    for name in dict.fromkeys(_SIGNATURES[n][0] for n in names):
        out = library_path(name)
        if out.exists():
            done[name] = (0.0, "")
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        done[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def launcher(name: str):
    """The ctypes function of a kernel's C launcher, built on first use."""
    fn = _FNS.get(name)
    if fn is None:
        source, symbol, argtypes = _SIGNATURES[name]
        lib = _LIBS.get(source)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(source)))
            _LIBS[source] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
