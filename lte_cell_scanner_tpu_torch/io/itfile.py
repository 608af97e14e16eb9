"""Reader/writer for the IT++ ``it_file`` binary container (format v3).

The reference stores captures and golden test vectors in ``.it`` files
written by IT++'s ``it_file`` class (used at src/capbuf.cpp:98-114,187-197
and throughout test/*.cpp). The format, reverse-engineered from the bundled
fixtures, is:

    magic   "IT++"              4 bytes
    version 0x03                1 byte
    records, each:
        uint64 header_bytes     (size of this header incl. the 3 uint64s)
        uint64 data_bytes       (payload size)
        uint64 block_bytes      (header_bytes + data_bytes)
        name\\0  type\\0  desc\\0  (NUL-terminated ASCII)
        payload                 (type-specific, little-endian)

Payload layouts (all little-endian):
    dvec / ivec / bvec / dcvec:  uint64 n, then n elements
        (float64 / int32 / uint8 / complex128 respectively)
    dmat / imat / dcmat:         uint64 rows, uint64 cols, then rows*cols
        elements stored column-major.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_MAGIC = b"IT++"
_VERSION = 3

# type tag -> (numpy dtype, is_matrix)
_TYPES = {
    "dvec": (np.float64, False),
    "ivec": (np.int32, False),
    "bvec": (np.uint8, False),
    "svec": (np.int16, False),
    "fvec": (np.float32, False),
    "dcvec": (np.complex128, False),
    "fcvec": (np.complex64, False),
    "dmat": (np.float64, True),
    "imat": (np.int32, True),
    "bmat": (np.uint8, True),
    "fmat": (np.float32, True),
    "dcmat": (np.complex128, True),
    "fcmat": (np.complex64, True),
}

_DTYPE_TO_TYPE = {
    ("float64", False): "dvec",
    ("int32", False): "ivec",
    ("uint8", False): "bvec",
    ("complex128", False): "dcvec",
    ("float64", True): "dmat",
    ("int32", True): "imat",
    ("uint8", True): "bmat",
    ("complex128", True): "dcmat",
}


def load_it(path: str) -> Dict[str, np.ndarray]:
    """Load every record of an ``.it`` file into a dict of numpy arrays.

    Matrices come back 2-D (row, col); vectors 1-D. ``bvec`` records are
    returned as uint8 arrays of 0/1.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not an IT++ file (magic {data[:4]!r})")
    if data[4] != _VERSION:
        raise ValueError(f"{path}: unsupported it_file version {data[4]}")

    out: Dict[str, np.ndarray] = {}
    pos = 5
    n = len(data)
    while pos + 24 <= n:
        hdr_bytes, data_bytes, block_bytes = struct.unpack_from("<QQQ", data, pos)
        if block_bytes == 0:
            break
        p = pos + 24
        name_end = data.index(b"\0", p)
        name = data[p:name_end].decode("ascii")
        p = name_end + 1
        type_end = data.index(b"\0", p)
        typ = data[p:type_end].decode("ascii")
        payload = data[pos + hdr_bytes : pos + hdr_bytes + data_bytes]
        out[name] = _parse_payload(typ, payload, f"{path}:{name}")
        pos += block_bytes
    return out


def _parse_payload(typ: str, payload: bytes, what: str) -> np.ndarray:
    if typ not in _TYPES:
        raise ValueError(f"{what}: unsupported it_file type {typ!r}")
    dtype, is_mat = _TYPES[typ]
    if is_mat:
        rows, cols = struct.unpack_from("<QQ", payload, 0)
        arr = np.frombuffer(payload, dtype=dtype, count=rows * cols, offset=16)
        # IT++ matrices are stored column-major.
        return arr.reshape(cols, rows).T.copy()
    (count,) = struct.unpack_from("<Q", payload, 0)
    return np.frombuffer(payload, dtype=dtype, count=count, offset=8).copy()


def save_it(path: str, records: Dict[str, np.ndarray]) -> None:
    """Write a dict of numpy arrays as an IT++ v3 ``.it`` file.

    dtypes are canonicalized: float->float64, int->int32, complex->complex128,
    bool->uint8 bvec. Arrays of ndim 2 become matrices (column-major on disk).
    """
    chunks = [b"IT++", bytes([_VERSION])]
    for name, arr in records.items():
        arr = np.asarray(arr)
        if arr.dtype == np.bool_:
            arr = arr.astype(np.uint8)
        elif np.issubdtype(arr.dtype, np.complexfloating):
            arr = arr.astype(np.complex128)
        elif np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float64)
        elif np.issubdtype(arr.dtype, np.integer) and arr.dtype != np.uint8:
            if arr.size and (arr.min() < np.iinfo(np.int32).min
                             or arr.max() > np.iinfo(np.int32).max):
                raise ValueError(
                    f"{name}: values exceed the .it ivec int32 range; "
                    "store as float64 instead")
            arr = arr.astype(np.int32)
        is_mat = arr.ndim == 2
        if arr.ndim > 2:
            raise ValueError(f"{name}: it_file supports at most 2-D arrays")
        typ = _DTYPE_TO_TYPE[(arr.dtype.name, is_mat)]
        if is_mat:
            payload = struct.pack("<QQ", arr.shape[0], arr.shape[1]) + arr.T.tobytes()
        else:
            payload = struct.pack("<Q", arr.shape[0]) + arr.tobytes()
        tail = name.encode("ascii") + b"\0" + typ.encode("ascii") + b"\0" + b"\0"
        hdr_bytes = 24 + len(tail)
        data_bytes = len(payload)
        block_bytes = hdr_bytes + data_bytes
        header = struct.pack("<QQQ", hdr_bytes, data_bytes, block_bytes)
        chunks.append(header + tail + payload)
    with open(path, "wb") as f:
        f.write(b"".join(chunks))
