"""Numerical-debugging dump facility.

reference: include/macros.h:55-72 (ITPP_DEBUG_EXPORT) + src/macros.cpp —
the reference's core numerical-debugging workflow dumps any intermediate
IT++ variable into ITPP_DEBUG.it for MATLAB/Octave inspection. This module
provides the same: ``dump(name, array)`` accumulates arrays (a tensor is
copied to the host) and writes an ``.it`` file loadable with itload, plus
``.npz`` for Python-side diffing.

    from lte_cell_scanner_tpu_torch.utils.debug_dump import dump, flush
    dump("h_raw", h_raw)
    ...
    flush("DEBUG.it")

With the environment variable LTE_TPU_DEBUG_DUMP set to a path, the
recorded arrays are flushed there when the process exits.
"""

from __future__ import annotations

import atexit
import os
from typing import Dict, Optional

import numpy as np

_STORE: Dict[str, np.ndarray] = {}
_AUTOFLUSH: Optional[str] = os.environ.get("LTE_TPU_DEBUG_DUMP")


def dump(name: str, array) -> None:
    """Record an intermediate array under ``name`` (last write wins)."""
    if hasattr(array, "detach"):                 # a torch tensor
        array = array.detach().cpu().numpy()
    _STORE[name] = np.asarray(array)


def clear() -> None:
    _STORE.clear()


def flush(path: str = "ITPP_DEBUG.it") -> str:
    """Write all recorded arrays; returns the path written."""
    from lte_cell_scanner_tpu_torch.io.itfile import save_it

    writable = {}
    for k, v in _STORE.items():
        if v.ndim > 2:
            v = v.reshape(v.shape[0], -1)
        writable[k] = v
    save_it(path, writable)
    np.savez(path + ".npz", **_STORE)
    return path


if _AUTOFLUSH:
    atexit.register(flush, _AUTOFLUSH)
