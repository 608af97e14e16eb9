"""ctypes bindings for the native (C++) sample feeder.

Counterpart of lte_cell_scanner_tpu/tracker/native_feeder.py, over the
same C functions of the repo's ``native/feeder.cpp``: the per-sample state
machine of tracker/producer.py's :class:`SampleFeeder` (the fractional LTE
clock, the searcher capture, every cell's symbol windows) runs in C++ on
the raw uint8 bytes.

The source is compiled with ``g++ -O2 -std=c++17 -fPIC -shared`` into
``build/native/libfeeder.so`` at the root of the checkout, again whenever
the source is newer than the library; the ``native/`` directory is only
read. A failed build or load raises: there is no fallback to the Python
feeder. In descriptor mode (the default, the batched engine's) a PDU
carries its window's absolute stream index and no samples; with
``emit_descriptors=False`` (the host CellTracker's) it carries its 128
complex samples, as the C++ side copied them from the raw bytes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Set

import numpy as np

from lte_cell_scanner_tpu_torch.constants import FRAME, FS_LTE
from lte_cell_scanner_tpu_torch.io.raw import iq_to_bytes
from lte_cell_scanner_tpu_torch.tracker.state import (GlobalState, SymbolPDU,
                                                      TrackedCell)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "feeder.cpp"
BUILD_DIR = ROOT / "build" / "native"
LIB_PATH = BUILD_DIR / "libfeeder.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_LIB: Optional[ctypes.CDLL] = None


def build_native(force: bool = False) -> Path:
    """Compile ``native/feeder.cpp`` into ``build/native/libfeeder.so``
    unless the library is newer than the source (or ``force``); returns
    its path. Raises RuntimeError naming what failed. A library this
    process has already loaded stays loaded: a rebuild serves the next
    process."""
    if not force and LIB_PATH.exists() and (LIB_PATH.stat().st_mtime
                                            >= SOURCE.stat().st_mtime):
        return LIB_PATH
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native feeder: no C++ compiler (g++) on PATH to "
                           f"build {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name, then rename: concurrent builds (test
    # workers) never load a half-written library.
    tmp = LIB_PATH.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native feeder: {cxx} failed on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_native()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"native feeder: cannot load {path}: {e}") from e
    P, L, D, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_double, ctypes.c_int
    for name, restype, argtypes in (
            ("feeder_create", P, [L]),
            ("feeder_destroy", None, [P]),
            ("feeder_set_step", None, [P, D]),
            ("feeder_set_descriptor_mode", None, [P, I]),
            ("feeder_sample_time", D, [P]),
            ("feeder_request_searcher", None, [P]),
            ("feeder_searcher_ready", I, [P]),
            ("feeder_searcher_late", D, [P]),
            ("feeder_take_searcher", L, [P, P]),
            ("feeder_set_cell", None, [P, I, I, I, D]),
            ("feeder_remove_cell", None, [P, I]),
            ("feeder_feed", None, [P, P, L, D]),
            ("feeder_pdu_count", L, [P]),
            ("feeder_get_pdus", None, [P, P, P, P]),
            ("feeder_get_pdu_starts", None, [P, P])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _LIB = lib
    return lib


class NativeSampleFeeder:
    """The interface of tracker.producer.SampleFeeder, with the per-sample
    state machine in C++ consuming the raw uint8 bytes (:meth:`feed_bytes`)."""

    def __init__(self, state: GlobalState,
                 searcher_capbuf_len: int = FRAME * 8,
                 emit_descriptors: bool = True):
        self._lib = _load()
        self.state = state
        self.searcher_capbuf_len = int(searcher_capbuf_len)
        self._h = self._lib.feeder_create(self.searcher_capbuf_len)
        self.emit_descriptors = emit_descriptors
        self._known: Set[int] = set()      # the cells the C++ side holds
        self.searcher_ready: Optional[np.ndarray] = None
        self.searcher_late = 0.0
        # feeder_get_pdus copies each PDU's sample payload (unused in
        # descriptor mode): a scratch buffer grown as needed receives it.
        self._scratch = np.empty(0, np.float32)

    @property
    def emit_descriptors(self) -> bool:
        return self._descriptors

    @emit_descriptors.setter
    def emit_descriptors(self, on: bool) -> None:
        self._descriptors = bool(on)
        self._lib.feeder_set_descriptor_mode(self._h, 1 if on else 0)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.feeder_destroy(h)
            self._h = None

    def request_searcher_capture(self) -> None:
        self._lib.feeder_request_searcher(self._h)

    def take_searcher_capture(self) -> Optional[np.ndarray]:
        buf, self.searcher_ready = self.searcher_ready, None
        return buf

    @property
    def sample_time(self) -> float:
        return self._lib.feeder_sample_time(self._h)

    def feed_bytes(self, raw: np.ndarray, cells: List[TrackedCell]) -> None:
        """Feed one block of interleaved uint8 IQ bytes. Cells are keyed
        by ``n_id_cell``: two cells with one ID share one state machine."""
        k_factor = self.state.k_factor()
        step = (FS_LTE / 16) / (self.state.fs_programmed * k_factor)
        self._lib.feeder_set_step(self._h, step)

        live = set()
        for cell in cells:
            if cell.kill_me:
                continue
            live.add(cell.n_id_cell)
            self._lib.feeder_set_cell(self._h, cell.n_id_cell,
                                      cell.serial_num, cell.n_symb_dl,
                                      cell.frame_timing)
        for n_id in self._known - live:
            self._lib.feeder_remove_cell(self._h, n_id)
        self._known = live

        raw = np.ascontiguousarray(raw, dtype=np.uint8)
        self._lib.feeder_feed(self._h, raw.ctypes.data, len(raw) // 2,
                              float(self.state.frequency_offset))

        n = self._lib.feeder_pdu_count(self._h)
        if n:
            meta = np.empty((n, 3), dtype=np.int32)
            vals = np.empty((n, 3), dtype=np.float64)
            if self._scratch.size < n * 256:
                self._scratch = np.empty(n * 256, np.float32)
            self._lib.feeder_get_pdus(self._h, meta.ctypes.data,
                                      vals.ctypes.data,
                                      self._scratch.ctypes.data)
            if self._descriptors:
                starts = np.empty(n, dtype=np.int64)
                self._lib.feeder_get_pdu_starts(self._h, starts.ctypes.data)
                datas = [None] * n
                starts = starts.tolist()
            else:
                iq = self._scratch[:n * 256].reshape(n, 128, 2)
                datas = list((iq[..., 0] + 1j * iq[..., 1]).astype(complex))
                starts = [None] * n
            by_id = {c.n_id_cell: c for c in cells}
            for m, v, s, d in zip(meta.tolist(), vals.tolist(), starts,
                                  datas):
                cell = by_id.get(m[0])
                if cell is None:
                    continue
                cell.push_pdu(SymbolPDU(
                    data=d, slot_num=m[1], sym_num=m[2], late=v[0],
                    frequency_offset=v[1], frame_timing=v[2], start=s))

        if self._lib.feeder_searcher_ready(self._h):
            out = np.empty(self.searcher_capbuf_len * 2, dtype=np.float32)
            self._lib.feeder_take_searcher(self._h, out.ctypes.data)
            self.searcher_late = self._lib.feeder_searcher_late(self._h)
            self.searcher_ready = (out[0::2] + 1j * out[1::2]).astype(complex)

    def feed(self, samples: np.ndarray, cells: List[TrackedCell]) -> None:
        """Compatibility shim: takes complex samples like the Python
        feeder and re-quantizes them (prefer feed_bytes on the raw
        stream)."""
        self.feed_bytes(iq_to_bytes(samples), cells)
