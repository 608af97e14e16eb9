"""Sample feeder: raw IQ stream -> fractional LTE clock -> symbol windows.

reference: src/producer_thread.cpp:59-252. The feeder advances a fractional
"LTE sample clock" mod 19200 by (FS_LTE/16)/(fs_programmed*k_factor) per
received sample — software resampling by index arithmetic. It fills the
searcher's capture buffer when the clock crosses zero and a request is
pending, and per tracked cell captures 128-sample OFDM-symbol windows
starting at frame_timing + target_cap_start_time (cyclic prefixes are
skipped by advancing the target by 128+{9,10,32}).

In descriptor mode (the default, the batched engine's) a PDU carries the
window's absolute stream index and the engine gathers the samples on the
device; with ``emit_descriptors=False`` (the host CellTracker's) it
carries a copy of its 128 complex samples. A C++ implementation of the
same state machine is tracker/native_feeder.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from lte_cell_scanner_tpu_torch.constants import FRAME, FS_LTE
from lte_cell_scanner_tpu_torch.tracker.state import (GlobalState, SymbolPDU,
                                                      TrackedCell)


@dataclasses.dataclass
class _CellCapture:
    """Per-cell symbol-window capture state (reference: cell_local_t)."""

    serial_num: int = 0
    slot_num: int = 0
    sym_num: int = 0
    target_cap_start_time: float = 0.0
    filling: bool = False
    buffer: Optional[np.ndarray] = None
    buffer_offset: int = 0
    late: float = 0.0
    frequency_offset: float = 0.0
    frame_timing: float = 0.0
    abs_start: int = 0


def slot_sym_inc(n_symb_dl: int, slot_num: int, sym_num: int):
    sym_num = (sym_num + 1) % n_symb_dl
    if sym_num == 0:
        slot_num = (slot_num + 1) % 20
    return slot_num, sym_num


class SampleFeeder:
    """Distributes a continuous sample stream to searcher + cell trackers."""

    def __init__(self, state: GlobalState, searcher_capbuf_len: int = FRAME * 8,
                 emit_descriptors: bool = True):
        self.state = state
        self.sample_time = -1.0
        self.searcher_capbuf_len = searcher_capbuf_len
        self.searcher_request = False
        self.searcher_filling = False
        self.searcher_capbuf = np.zeros(searcher_capbuf_len, dtype=complex)
        self.searcher_idx = 0
        self.searcher_late = 0.0
        self.searcher_ready: Optional[np.ndarray] = None
        self._cells: Dict[int, _CellCapture] = {}
        self._step = 1.0
        # Descriptor mode (the batched engine): PDUs carry the window's
        # absolute stream index instead of a copy of the samples.
        self.emit_descriptors = emit_descriptors
        self.abs_sample = 0

    def request_searcher_capture(self) -> None:
        self.searcher_request = True

    def take_searcher_capture(self) -> Optional[np.ndarray]:
        buf, self.searcher_ready = self.searcher_ready, None
        return buf

    def feed(self, samples: np.ndarray, cells: List[TrackedCell]) -> None:
        """Process one block of complex samples at fs_programmed*k_factor."""
        fo = self.state.frequency_offset
        k_factor = self.state.k_factor()
        step = (FS_LTE / 16) / (self.state.fs_programmed * k_factor)

        n = len(samples)
        ts = self.sample_time + step * np.arange(1, n + 1)
        ts = np.mod(ts, FRAME)
        self.sample_time = float(ts[-1])
        self._step = step

        # ---- searcher capture buffer
        if self.searcher_request or self.searcher_filling:
            self._feed_searcher(samples, ts)

        # ---- per-cell symbol windows
        for cell in cells:
            if cell.kill_me:
                self._cells.pop(cell.n_id_cell, None)
                continue
            self._feed_cell(cell, samples, ts, fo)
        self.abs_sample += n

    # -- internals ---------------------------------------------------------

    def _feed_searcher(self, samples: np.ndarray, ts: np.ndarray) -> None:
        n = len(samples)
        start = 0
        if self.searcher_request and not self.searcher_filling:
            # Trigger when the LTE clock crosses 0 (within half a sample).
            d = np.mod(ts + FRAME / 2, FRAME) - FRAME / 2
            hits = np.nonzero(np.abs(d) < 0.5)[0]
            if len(hits) == 0:
                return
            start = int(hits[0])
            self.searcher_request = False
            self.searcher_filling = True
            self.searcher_idx = 0
            self.searcher_late = float(d[start])
        if self.searcher_filling:
            take = min(n - start, self.searcher_capbuf_len - self.searcher_idx)
            self.searcher_capbuf[self.searcher_idx:self.searcher_idx + take] = \
                samples[start:start + take]
            self.searcher_idx += take
            if self.searcher_idx == self.searcher_capbuf_len:
                self.searcher_filling = False
                self.searcher_ready = self.searcher_capbuf.copy()

    def _feed_cell(self, cell: TrackedCell, samples: np.ndarray,
                   ts: np.ndarray, fo: float) -> None:
        cl = self._cells.get(cell.n_id_cell)
        if cl is None or cl.serial_num != cell.serial_num:
            cl = _CellCapture(serial_num=cell.serial_num)
            cl.target_cap_start_time = 10 if cell.cp_type == "normal" else 32
            cl.buffer = np.zeros(128, dtype=complex)
            self._cells[cell.n_id_cell] = cl

        frame_timing = cell.frame_timing
        n = len(samples)
        step = self._step
        t = 0
        while t < n:
            if not cl.filling:
                target = frame_timing + cl.target_cap_start_time
                # Trigger on |diff| < 0.5, or 0 < diff < 3 (missed the
                # ideal start because frame timing moved). The LTE clock
                # rises ~step per sample, so while diff < -0.5 no trigger
                # is possible: skip ahead arithmetically (O(1) per symbol
                # instead of scanning the whole remaining block) and only
                # evaluate a short window around the predicted crossing.
                hit = None
                while t < n:
                    d0 = np.mod(ts[t] - target + FRAME / 2, FRAME) \
                        - FRAME / 2
                    if not (abs(d0) < 0.5 or 0 < d0 < 3):
                        n_skip = int(((-0.5 - d0) % FRAME) / step) - 1
                        if n_skip > 0:
                            t += n_skip
                            continue
                    d = np.mod(ts[t:t + 8] - target + FRAME / 2, FRAME) \
                        - FRAME / 2
                    loc = np.nonzero((np.abs(d) < 0.5)
                                     | ((d > 0) & (d < 3)))[0]
                    if len(loc):
                        hit = t + int(loc[0])
                        late = float(d[loc[0]])
                        break
                    t += len(d)
                if hit is None:
                    return
                t = hit
                cl.filling = True
                cl.late = late
                cl.buffer_offset = 0
                cl.frequency_offset = fo
                cl.frame_timing = frame_timing
                cl.abs_start = self.abs_sample + t
            take = min(n - t, 128 - cl.buffer_offset)
            if not self.emit_descriptors:
                cl.buffer[cl.buffer_offset:cl.buffer_offset + take] = \
                    samples[t:t + take]
            cl.buffer_offset += take
            t += take
            if cl.buffer_offset == 128:
                cell.push_pdu(SymbolPDU(
                    data=(None if self.emit_descriptors
                          else cl.buffer.copy()),
                    slot_num=cl.slot_num,
                    sym_num=cl.sym_num, late=cl.late,
                    frequency_offset=cl.frequency_offset,
                    frame_timing=cl.frame_timing,
                    start=(cl.abs_start if self.emit_descriptors
                           else None)))
                cl.filling = False
                if cell.cp_type == "extended":
                    cl.target_cap_start_time += 32 + 128
                else:
                    cl.target_cap_start_time += (128 + 10) if cl.sym_num == 6 \
                        else (128 + 9)
                cl.target_cap_start_time %= FRAME
                cl.slot_num, cl.sym_num = slot_sym_inc(
                    cell.n_symb_dl, cl.slot_num, cl.sym_num)
