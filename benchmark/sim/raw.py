"""Raw rtl_sdr captures: interleaved uint8 I/Q, normalized (x-127)/128.

reference: src/itpp_ext.cpp:176-217 (rtl_sdr_to_cvec) and the byte->complex
conversion in src/capbuf.cpp:172-181.
"""

from __future__ import annotations

import numpy as np


def bytes_to_iq(raw: np.ndarray) -> np.ndarray:
    """Convert interleaved uint8 I/Q samples to complex128, (x-127)/128."""
    raw = np.asarray(raw, dtype=np.float64)
    if raw.size % 2:
        raw = raw[:-1]
    i = (raw[0::2] - 127.0) / 128.0
    q = (raw[1::2] - 127.0) / 128.0
    return i + 1j * q


def iq_to_bytes(iq: np.ndarray) -> np.ndarray:
    """Re-quantize complex samples to the rtl_sdr uint8 format.

    Mirrors the tracker's file-playback path which pushes synthesized
    captures through the same uint8 FIFO as live USB data
    (reference: src/LTE-Tracker.cpp:833-866).
    """
    iq = np.asarray(iq)
    i = np.clip(np.round(iq.real * 128.0 + 127.0), 0, 255)
    q = np.clip(np.round(iq.imag * 128.0 + 127.0), 0, 255)
    out = np.empty(iq.size * 2, dtype=np.uint8)
    out[0::2] = i.astype(np.uint8)
    out[1::2] = q.astype(np.uint8)
    return out


def load_rtl_sdr(path: str, drop_seconds: float = 0.0,
                 fs: float = 1.92e6) -> np.ndarray:
    """Load a raw rtl_sdr capture file, optionally dropping leading seconds."""
    raw = np.fromfile(path, dtype=np.uint8)
    iq = bytes_to_iq(raw)
    n_drop = int(round(drop_seconds * fs))
    return iq[n_drop:]
