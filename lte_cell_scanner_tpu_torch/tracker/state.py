"""Shared tracker state.

reference: include/LTE-Tracker.h:9-252 — the reference guards these fields
with per-field mutexes across five thread types; this runtime is a
single-threaded event loop, so the state is plain Python with the same
update semantics.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional

import numpy as np

from lte_cell_scanner_tpu_torch.constants import CELL_DROP_THRESHOLD, FRAME


@dataclasses.dataclass
class SymbolPDU:
    """One OFDM symbol's worth of time-domain samples.

    reference: td_fifo_pdu_t (include/LTE-Tracker.h:19-31).

    In descriptor mode (the engine's default) ``data`` is None and
    ``start`` is the absolute index of the window's first sample in the
    raw stream: the engine gathers the 128 samples on the device from the
    stream it uploads once per cycle. In sample-carrying mode (the host
    CellTracker's) ``data`` holds the 128 complex samples and ``start`` is
    None.
    """

    data: Optional[np.ndarray]  # (128,) complex, or None in descriptor mode
    slot_num: int
    sym_num: int
    late: float               # fractional start-time error (samples)
    frequency_offset: float   # global FO at capture time
    frame_timing: float       # cell frame timing at capture time
    start: Optional[int] = None  # absolute stream index (descriptor mode)


@dataclasses.dataclass
class GlobalState:
    """Global tracker state (reference: global_thread_data_t)."""

    fc_requested: float
    fc_programmed: float
    fs_programmed: float
    frequency_offset: float = 0.0
    raw_seconds_dropped: int = 0
    cell_seconds_dropped: int = 0
    searcher_cycle_time: float = float("nan")
    # Nine free-form experiment knobs, settable from the CLI
    # (--g1..--g9) and readable anywhere through the shared state —
    # the reference's hidden scratch debug globals
    # (src/LTE-Tracker.cpp:52-60,158-166).
    debug_g: tuple = (0.0,) * 9

    def k_factor(self) -> float:
        return (self.fc_requested - self.frequency_offset) / self.fc_programmed

    def update_frequency_offset(self, new_est: float, est_np: float,
                                prior_np: float = 1e-6) -> None:
        """Inverse-variance blend of a new FO estimate into the global FO.

        reference: src/tracker_thread.cpp:235-242.
        """
        w_prior = 1.0 / prior_np
        w_new = 1.0 / est_np
        self.frequency_offset = (
            self.frequency_offset * w_prior + new_est * w_new) / (w_prior + w_new)


@dataclasses.dataclass
class TrackedCell:
    """Per-cell tracking state (reference: tracked_cell_t)."""

    n_id_cell: int
    n_ports: int
    cp_type: str
    n_rb_dl: int
    phich_duration: str
    phich_resource: float
    frame_timing: float          # in the 19200-sample LTE frame clock
    serial_num: int = 1
    drop_threshold: float = CELL_DROP_THRESHOLD

    fifo: Deque[SymbolPDU] = dataclasses.field(default_factory=deque)
    fifo_peak_size: int = 0
    kill_me: bool = False
    tracker_ready: bool = True   # event-loop runtime is always ready

    # Health: MIB decode failure counter; +1 per failure when synchronized,
    # +0.25 while hunting; cell dropped at drop_threshold.
    mib_decode_failures: float = 0.0
    mib_decode_successes: int = 0

    # Measurements (rendered by the display)
    sync_tp: float = float("nan")
    sync_sp: float = float("nan")
    sync_np: float = float("nan")
    sync_np_blank: float = float("nan")
    sync_tp_av: float = float("nan")
    sync_sp_av: float = float("nan")
    sync_np_av: float = float("nan")
    sync_np_blank_av: float = float("nan")
    sync_ce: Optional[np.ndarray] = None
    crs_tp_av: Optional[np.ndarray] = None
    crs_sp_raw_av: Optional[np.ndarray] = None
    crs_np_av: Optional[np.ndarray] = None
    ce: Optional[np.ndarray] = None          # (n_ports, 72) latest CE
    ac_fd: Optional[np.ndarray] = None       # (12,) freq autocorrelation
    ac_td: Optional[np.ndarray] = None       # (72,) time autocorrelation

    @property
    def n_symb_dl(self) -> int:
        return 7 if self.cp_type == "normal" else 6

    @property
    def health(self) -> float:
        """Remaining health fraction 1.0 (good) .. 0.0 (dropped)."""
        return max(0.0, 1.0 - self.mib_decode_failures / self.drop_threshold)

    def push_pdu(self, pdu: SymbolPDU) -> None:
        self.fifo.append(pdu)
        self.fifo_peak_size = max(self.fifo_peak_size, len(self.fifo))

    def update_frame_timing(self, delay: float, delay_np: float,
                            base_timing: float,
                            prior_np: float = 1e-4) -> None:
        """Inverse-variance blend of a TOE measurement into frame timing.

        reference: src/tracker_thread.cpp do_toe_v2 (:272-279).
        """
        diff = (base_timing + delay - self.frame_timing + FRAME / 2) % FRAME \
            - FRAME / 2
        w_prior = 1.0 / prior_np
        w_new = 1.0 / delay_np
        diff = diff * w_new / (w_prior + w_new)
        self.frame_timing = (self.frame_timing + diff) % FRAME
