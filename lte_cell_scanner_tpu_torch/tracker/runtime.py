"""The realtime multi-cell tracker runtime.

reference: src/LTE-Tracker.cpp + the four thread modules. The reference
wires five boost::thread types through mutex+condvar FIFOs; this runtime is
a deterministic event loop — each iteration ingests one block of samples,
advances the feeder, runs the data plane (the batched device engine every
``engine_every`` blocks, or one host CellTracker per cell), and runs the
searcher when a capture completes.
The same feedback loops exist:

    tracker FOE -> global frequency offset -> feeder's k_factor resampling
    tracker TOE -> cell frame_timing       -> feeder's capture trigger

File playback pushes recorded/synthesized captures through the same uint8
re-quantization as live data (reference: src/LTE-Tracker.cpp:833-866), so
the whole stack is testable without hardware.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from lte_cell_scanner_tpu_torch.constants import (CELL_DROP_THRESHOLD, FRAME,
                                                  FS_LTE)
from lte_cell_scanner_tpu_torch.io.raw import bytes_to_iq, iq_to_bytes
from lte_cell_scanner_tpu_torch.tracker.batch_runtime import (
    BatchTrackerEngine)
from lte_cell_scanner_tpu_torch.tracker.cell_tracker import CellTracker
from lte_cell_scanner_tpu_torch.tracker.native_feeder import (
    NativeSampleFeeder)
from lte_cell_scanner_tpu_torch.tracker.producer import SampleFeeder
from lte_cell_scanner_tpu_torch.tracker.searcher import (kalibrate,
                                                         searcher_pass)
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell
from lte_cell_scanner_tpu_torch.utils.device import resolve_device
from lte_cell_scanner_tpu_torch.utils.profiling import TRACER

BLOCK_SIZE = 10000


def playback_source(capbuf: np.ndarray, repeat: bool = True,
                    noise_power: Optional[float] = None,
                    seed: int = 0) -> Iterator[np.ndarray]:
    """Yield uint8 IQ blocks of BLOCK_SIZE samples from a recorded or
    synthesized capture.

    Mirrors the reference's file playback: optional calibrated AWGN of
    ``noise_power`` (drawn from ``np.random.default_rng(seed)``), then
    re-quantization to uint8 through the same path as live USB data.
    With ``repeat`` the capture loops forever; without, the source ends
    after the capture's last (possibly short) block.
    """
    rng = np.random.default_rng(seed)
    pos = 0
    sig = np.asarray(capbuf)
    while True:
        block = sig[pos:pos + BLOCK_SIZE]
        if len(block) < BLOCK_SIZE:
            if not repeat:
                if len(block):
                    yield _quantize(block, noise_power, rng)
                return
            block = np.concatenate([block, sig[:BLOCK_SIZE - len(block)]])
            pos = (pos + BLOCK_SIZE) % len(sig)
        else:
            pos += BLOCK_SIZE
        yield _quantize(block, noise_power, rng)


def _quantize(block, noise_power, rng):
    if noise_power is not None:
        block = block + (rng.standard_normal(len(block))
                         + 1j * rng.standard_normal(len(block))) \
            * np.sqrt(noise_power / 2)
    return iq_to_bytes(block)


class LTETracker:
    """Tracks every detectable cell on one center frequency.

    ``batch=True`` (the default) runs the data plane as the batched engine
    (tracker/batch_runtime.py) on ``device``: ``None`` is the CUDA card (it
    raises if there is none), ``"cpu"`` the kernels' plain PyTorch
    versions. Its feeder emits descriptors; a caller who sets
    ``feeder.emit_descriptors = False`` drives the engine's
    sample-carrying mode. ``batch=False`` runs one host CellTracker per
    cell (float64 NumPy), fed sample-carrying PDUs. ``backend`` is the
    searcher's and kalibrate's: ``"torch"`` (the default) the cell search
    on ``device``, ``"numpy"`` the float64 host chain (with ``batch=False``
    too, nothing runs on a device). ``engine_every`` is the engine's
    cadence in input blocks: larger values amortize each cycle's fixed
    cost at the price of feedback-loop lag (20 ~ one cycle per 104 ms of
    signal). ``feeder="native"`` runs the sample feeder in C++
    (tracker/native_feeder.py) on the raw bytes. ``drop_threshold`` is
    every acquired cell's (unset: CELL_DROP_THRESHOLD). ``ce_observer`` is
    the data plane's optional per-symbol CE tap (BatchTrackerEngine,
    CellTracker).
    """

    def __init__(self, fc_requested: float,
                 fc_programmed: Optional[float] = None,
                 fs_programmed: float = 1.92e6,
                 initial_freq_offset: float = 0.0, backend: str = "torch",
                 batch: bool = True, engine_every: int = 1,
                 feeder: str = "python",
                 on_event: Optional[Callable[[str, dict], None]] = None,
                 drop_threshold: Optional[float] = None,
                 ce_observer: Optional[tuple] = None, device=None):
        if backend not in ("torch", "numpy"):
            raise ValueError(f"backend must be 'torch' or 'numpy', not "
                             f"{backend!r}")
        self.state = GlobalState(
            fc_requested=fc_requested,
            fc_programmed=fc_programmed if fc_programmed else fc_requested,
            fs_programmed=fs_programmed,
            frequency_offset=initial_freq_offset)
        self.backend = backend
        self.ce_observer = ce_observer
        self.engine = None
        self.device = None
        if batch:
            self.engine = BatchTrackerEngine(self.state, device=device)
            self.engine.ce_observer = ce_observer
            self.device = self.engine.device
        elif backend == "torch":
            self.device = resolve_device(device)
        if feeder == "native":
            self.feeder = NativeSampleFeeder(self.state,
                                             emit_descriptors=batch)
        elif feeder == "python":
            self.feeder = SampleFeeder(self.state, emit_descriptors=batch)
        else:
            raise ValueError(f"feeder must be 'python' or 'native', not "
                             f"{feeder!r}")
        self.drop_threshold = (drop_threshold if drop_threshold is not None
                               else CELL_DROP_THRESHOLD)
        self.cells: List[TrackedCell] = []
        self.trackers: Dict[int, CellTracker] = {}
        self.serial_num: Dict[int, int] = {}
        self.on_event = on_event or (lambda kind, info: None)
        self.feeder.request_searcher_capture()
        self.n_blocks = 0
        self.searcher_passes = 0
        self.engine_every = max(1, engine_every)

    # ------------------------------------------------------------------
    def kalibrate(self, sample_source: Iterator[np.ndarray],
                  ppm: float = 120, max_blocks: int = 10000,
                  correction: float = 1.0) -> float:
        """Initial LO calibration: run one-shot cell searches on raw input
        until a cell decodes; seed the global FO with its freq_superfine.
        ``correction`` centers the hypothesis grid on a previously
        calibrated crystal's offset (src/LTE-Tracker.cpp:586).

        reference: src/LTE-Tracker.cpp:565-741.
        """
        fo = kalibrate(sample_source, self.state, ppm=ppm,
                       max_blocks=max_blocks, correction=correction,
                       device=self.device, backend=self.backend)
        self.state.frequency_offset = fo
        self.on_event("kalibrate", {"frequency_offset": fo})
        return fo

    # ------------------------------------------------------------------
    def run(self, sample_source: Iterator[np.ndarray],
            max_blocks: Optional[int] = None) -> int:
        """Ingest blocks until the source ends (or max_blocks this call).

        Returns the number of blocks processed by this call.
        """
        n = 0
        for raw in sample_source:
            self.step(raw)
            n += 1
            if max_blocks is not None and n >= max_blocks:
                break
        return n

    @TRACER.traced("tracker.step")
    def step(self, raw_block: np.ndarray) -> None:
        """Process one block of raw uint8 IQ samples: the tracer's span
        ``tracker.step``, holding ``tracker.feed``, the engine's cycle
        and any searcher pass (``tracker.searcher``)."""
        self.n_blocks += 1
        if self.engine is not None:
            self.engine.push_raw(raw_block)

        # Reap killed cells (reference: producer_thread.cpp:191-197).
        for cell in list(self.cells):
            if cell.kill_me:
                self.cells.remove(cell)
                self.trackers.pop(cell.n_id_cell, None)
                self.on_event("cell_dropped", {"n_id_cell": cell.n_id_cell})

        with TRACER.span("tracker.feed"):
            if isinstance(self.feeder, NativeSampleFeeder):
                self.feeder.feed_bytes(raw_block, self.cells)
            else:
                self.feeder.feed(bytes_to_iq(raw_block), self.cells)
        if self.engine is None:
            for cell in self.cells:
                self.trackers[cell.n_id_cell].process_available()
        elif self.n_blocks % self.engine_every == 0:
            self.engine.process_all(self.cells)

        capbuf = self.feeder.take_searcher_capture()
        if capbuf is not None:
            self._run_searcher(capbuf, self.feeder.searcher_late)
            self.feeder.request_searcher_capture()

    # ------------------------------------------------------------------
    @TRACER.traced("tracker.searcher")
    def _run_searcher(self, capbuf: np.ndarray, late: float) -> None:
        """One searcher cycle on a fresh capture buffer.

        reference: src/searcher_thread.cpp:83-233. The tracer's span
        ``tracker.searcher``; ``status()`` reports the passes made.
        """
        t0 = time.perf_counter()
        tracked_ids = {c.n_id_cell for c in self.cells}
        found = searcher_pass(capbuf, self.state, tracked_ids,
                              device=self.device, backend=self.backend)
        for cell_res in found:
            k_factor = self.state.k_factor()
            frame_timing = np.mod(
                cell_res.frame_start * (FS_LTE / 16)
                / (self.state.fs_programmed * k_factor) + late, FRAME)
            n_id = cell_res.n_id_cell()
            serial = self.serial_num.get(n_id, 0) + 1
            self.serial_num[n_id] = serial
            cell = TrackedCell(
                n_id_cell=n_id, n_ports=cell_res.n_ports,
                cp_type=cell_res.cp_type, n_rb_dl=cell_res.n_rb_dl,
                phich_duration=cell_res.phich_duration,
                phich_resource=cell_res.phich_resource,
                frame_timing=float(frame_timing), serial_num=serial,
                drop_threshold=self.drop_threshold)
            self.cells.append(cell)
            if self.engine is None:
                self.trackers[n_id] = CellTracker(cell, self.state)
                self.trackers[n_id].ce_observer = self.ce_observer
            self.on_event("cell_acquired", {
                "n_id_cell": n_id, "n_ports": cell.n_ports,
                "n_rb_dl": cell.n_rb_dl, "cp_type": cell.cp_type,
                "frame_timing": cell.frame_timing})
        self.state.searcher_cycle_time = time.perf_counter() - t0
        self.searcher_passes += 1

    # ------------------------------------------------------------------
    def status(self) -> dict:
        """Snapshot of all metrics (consumed by the display)."""
        return {
            "frequency_offset": self.state.frequency_offset,
            "searcher_cycle_time": self.state.searcher_cycle_time,
            "searcher_passes": self.searcher_passes,
            "raw_seconds_dropped": self.state.raw_seconds_dropped,
            "cell_seconds_dropped": self.state.cell_seconds_dropped,
            "debug_g": self.state.debug_g,
            "cells": [{
                "n_id_cell": c.n_id_cell,
                "n_ports": c.n_ports,
                "cp_type": c.cp_type,
                "n_rb_dl": c.n_rb_dl,
                "frame_timing": c.frame_timing,
                "health": c.health,
                "mib_successes": c.mib_decode_successes,
                "fifo_peak": c.fifo_peak_size,
                "sync_snr_db": (10 * np.log10(c.sync_sp_av / c.sync_np_av)
                                if c.sync_np_av and not np.isnan(c.sync_np_av)
                                else float("nan")),
            } for c in self.cells],
        }
