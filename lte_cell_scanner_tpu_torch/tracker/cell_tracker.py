"""Per-cell tracking: symbol demod, channel tracking, MIB health loop.

reference: src/tracker_thread.cpp. Each tracked cell consumes 128-sample
symbol PDUs and maintains:

- get_fd: FOC (ICI removal) -> 2-sample TOC -> DFT -> 72 subcarriers ->
  fractional-timing phase ramp + accumulated bulk phase offset,
- raw CE at RS positions per port; 3-symbol hex filtering; noise/signal
  power with bias correction,
- do_foe: MRC frequency-offset estimate, blended into the GLOBAL FO,
- do_toe_v2: staggered-RS timing estimate, blended into the cell's
  frame_timing (read back by the sample feeder — the key feedback loop),
- FD/TD channel autocorrelation measurements,
- linear CE interpolation to every OFDM symbol,
- the MIB decode health loop: 4 frames of PBCH symbols per attempt,
  +1 failure when synchronized / +0.25 while hunting, cell dropped at
  the cell's drop_threshold.

This is the host data plane (``LTETracker(batch=False)``): one CellTracker
per cell, in float64 NumPy, fed sample-carrying PDUs. The batched engine
(tracker/batch_runtime.py) is the device data plane.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional

import numpy as np

from lte_cell_scanner_tpu_torch.constants import FRAME, FS_LTE
from lte_cell_scanner_tpu_torch.models.convcode import lte_conv_decode
from lte_cell_scanner_tpu_torch.models.crc import lte_calc_crc
from lte_cell_scanner_tpu_torch.models.modulation import lte_demodulate
from lte_cell_scanner_tpu_torch.models.pn import lte_pn
from lte_cell_scanner_tpu_torch.models.pss import pss_fd
from lte_cell_scanner_tpu_torch.models.ratematch import lte_conv_deratematch
from lte_cell_scanner_tpu_torch.models.rs import RSDL
from lte_cell_scanner_tpu_torch.models.sss import sss_fd
from lte_cell_scanner_tpu_torch.ops.pbch import N_RB_DL_TABLE, PHICH_RES_TABLE
from lte_cell_scanner_tpu_torch.tracker.producer import slot_sym_inc
from lte_cell_scanner_tpu_torch.tracker.state import GlobalState, TrackedCell

_CN = np.concatenate([np.arange(-36, 0), np.arange(1, 37)]).astype(float)


def _wrap_half_frame(x):
    return np.mod(x + FRAME / 2, FRAME) - FRAME / 2


@dataclasses.dataclass
class _RawCE:
    shift: int
    slot_num: int
    sym_num: int
    ce: np.ndarray            # (12,)
    frequency_offset: float
    frame_timing: float


@dataclasses.dataclass
class _FiltCE:
    shift: int
    slot_num: int
    sym_num: int
    tp: float
    sp: float
    sp_raw: float
    np_: float
    ce_filt: np.ndarray


@dataclasses.dataclass
class _InterpCE:
    slot_num: int
    sym_num: int
    ce: np.ndarray            # (72,)
    tp: float
    sp: float
    sp_raw: float
    np_: float


class CellTracker:
    """Event-driven equivalent of one reference tracker thread."""

    def __init__(self, cell: TrackedCell, state: GlobalState):
        self.cell = cell
        self.state = state
        self.rs_dl = RSDL(cell.n_id_cell, 6, cell.cp_type)
        m_bit = 1920 if cell.cp_type == "normal" else 1728
        self.scr = lte_pn(cell.n_id_cell, m_bit)
        self.slot_num = 0
        self.sym_num = 0
        self.bulk_phase_offset = 0.0
        self.data_fifo: Deque = deque()
        n_ports = cell.n_ports
        self.ce_raw_fifo = [deque() for _ in range(n_ports)]
        self.ce_filt_fifo = [deque() for _ in range(n_ports)]
        self.ce_interp_fifo: list = [deque() for _ in range(n_ports)]
        self.ce_interp_init = [False] * n_ports
        self.ce_history = [deque(maxlen=72) for _ in range(n_ports)]
        self.mib_fifo: Deque = deque()
        # Optional (filter, callback) pair: per-symbol interpolated CE
        # for consumers beyond sync/PBCH (e.g. PDSCH work). filter(slot,
        # sym) selects symbols; callback(n_id_cell, slot, sym, ce, sp,
        # np_) receives the (n_ports, 72) estimate the reference's
        # tracker_thread computes for every OFDM symbol
        # (src/tracker_thread.cpp:372-477).
        self.ce_observer = None
        self.mib_fifo_synchronized = False
        self.sss_sym: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def process_available(self) -> None:
        """Drain the cell's PDU fifo."""
        cell = self.cell
        # Overload: drop 1 s of symbols if more than 1.5 s behind.
        n_ofdm_1s = cell.n_symb_dl * 2 * 1000
        while len(cell.fifo) > n_ofdm_1s * 1.5:
            for _ in range(n_ofdm_1s):
                cell.fifo.popleft()
            self.state.cell_seconds_dropped += 1
        while cell.fifo and not cell.kill_me:
            self._process_one(cell.fifo.popleft())

    # ------------------------------------------------------------------
    def _get_fd(self, pdu) -> np.ndarray:
        """FOC + TOC + DFT + 72 SC + fractional-timing & bulk phase comp.

        reference: src/tracker_thread.cpp:91-174.
        """
        cell = self.cell
        fo = pdu.frequency_offset
        k_factor = (self.state.fc_requested - fo) / self.state.fc_programmed
        t = np.arange(128)
        data = pdu.data * np.exp(
            1j * 2 * np.pi * -fo * t / (self.state.fs_programmed * k_factor))
        data = np.concatenate([data[2:], data[:2]])
        dft_out = np.fft.fft(data) / np.sqrt(128.0)
        syms = np.concatenate([dft_out[92:128], dft_out[1:37]])

        if cell.cp_type == "extended":
            n_samp_elapsed = 128 + 32
        else:
            n_samp_elapsed = 128 + 10 if pdu.sym_num == 0 else 128 + 9
        self.bulk_phase_offset = float(np.mod(
            self.bulk_phase_offset
            + 2 * np.pi * n_samp_elapsed * (1 / (FS_LTE / 16)) * -fo + np.pi,
            2 * np.pi) - np.pi)
        ramp = np.exp(-1j * 2 * np.pi * pdu.late * _CN / 128.0)
        return syms * np.exp(1j * self.bulk_phase_offset) * ramp

    # ------------------------------------------------------------------
    def _process_one(self, pdu) -> None:
        cell = self.cell
        syms = self._get_fd(pdu)
        self.data_fifo.append((pdu.slot_num, pdu.sym_num, syms))

        # Extract RS for each port.
        for port in range(cell.n_ports):
            shift = self.rs_dl.get_shift(pdu.slot_num, pdu.sym_num, port)
            if np.isnan(shift):
                continue
            shift = int(shift)
            rs = self.rs_dl.get_rs(pdu.slot_num, pdu.sym_num)
            ce_raw = syms[shift::6] * np.conj(rs)
            self.ce_raw_fifo[port].append(_RawCE(
                shift, pdu.slot_num, pdu.sym_num, ce_raw,
                pdu.frequency_offset, pdu.frame_timing))

        for port in range(cell.n_ports):
            if len(self.ce_raw_fifo[port]) == 3:
                self._process_raw_ce(port)
            if len(self.ce_filt_fifo[port]) == 2:
                self._interp2d(port)

        # Process data symbols once every port has interpolated CE.
        while self.data_fifo and all(f for f in self.ce_interp_fifo):
            slot_num, sym_num, dsyms = self.data_fifo.popleft()
            interp = [f.popleft() for f in self.ce_interp_fifo]
            ce = np.stack([p.ce for p in interp])
            sp = np.array([p.sp for p in interp])
            np_ = np.array([p.np_ for p in interp])
            cell.ce = ce
            obs = self.ce_observer
            if obs is not None and obs[0](slot_num, sym_num):
                obs[1](cell.n_id_cell, slot_num, sym_num, ce.copy(),
                       sp.copy(), np_.copy())
            self._update_crs_measurements(slot_num, sym_num, interp)
            self._sigpower_pss_sss(dsyms, slot_num, sym_num)
            self._mib_step(dsyms, ce, sp, np_, slot_num, sym_num)
            if cell.kill_me:
                return

        self.slot_num, self.sym_num = slot_sym_inc(
            cell.n_symb_dl, self.slot_num, self.sym_num)

    # ------------------------------------------------------------------
    def _process_raw_ce(self, port: int) -> None:
        """Filter + FOE + TOE + autocorrelation measurements.

        reference: src/tracker_thread.cpp:176-370 and the raw-CE loop
        :912-958.
        """
        rs_prev, rs_curr, rs_next = self.ce_raw_fifo[port]

        # 3-symbol hex filter (reference: filter_ce :176-202)
        ce_filt = np.empty(12, dtype=complex)
        for t in range(12):
            ind = [i for i in (t - 1, t, t + 1) if 0 <= i < 12]
            total = rs_curr.ce[ind].sum()
            n_total = len(ind)
            if rs_prev.shift < rs_curr.shift:
                ind2 = [i for i in (t, t + 1) if 0 <= i < 12]
            else:
                ind2 = [i for i in (t - 1, t) if 0 <= i < 12]
            total += rs_prev.ce[ind2].sum() + rs_next.ce[ind2].sum()
            n_total += 2 * len(ind2)
            ce_filt[t] = total / n_total

        np_curr = float(np.mean(np.abs(rs_curr.ce - ce_filt) ** 2)) * 7 / 6
        tp_curr = float(np.mean(np.abs(ce_filt) ** 2))
        sp_raw = tp_curr - np_curr / 7
        sp_curr = max(1e-5, sp_raw)

        self.ce_filt_fifo[port].append(_FiltCE(
            rs_curr.shift, rs_curr.slot_num, rs_curr.sym_num,
            tp_curr, sp_curr, sp_raw, np_curr, ce_filt))

        self._do_foe(rs_prev, rs_next, np_curr, ce_filt)
        self._do_toe_v2(rs_prev, rs_curr, sp_curr, np_curr)
        self._do_ac_fd(rs_curr, sp_curr, np_curr)
        self._do_ac_td(rs_curr, sp_curr, port)
        self.ce_raw_fifo[port].popleft()

    def _do_foe(self, rs_prev, rs_next, np_curr, ce_filt) -> None:
        """MRC FOE across the comb; update the global frequency offset."""
        foe = np.conj(rs_prev.ce) * rs_next.ce
        cf2 = np.abs(ce_filt) ** 2
        # Noiseless input (synthetic captures) gives np_curr == 0; the
        # weights then diverge but the normalized estimate has the
        # well-defined limit sum(foe)/sum(cf2) — a tiny floor reaches it
        # without inf/NaN (the batch engine zero-weights non-finite rows
        # the same way, tracker/batch_runtime.py).
        np_curr = max(np_curr, 1e-20)
        foe_np = np_curr * np_curr + 2 * np_curr * cf2
        weight = cf2 / foe_np
        foe_comb = np.sum(foe * weight)
        foe_comb_np = np.sum(foe_np * weight * weight)
        norm = np.sum(cf2 * weight)
        if norm == 0.0:
            return   # all-zero CE (blanked/overload windows): no info
        scale = 1.0 / norm
        foe_comb *= scale
        foe_comb_np *= scale * scale

        fo = rs_prev.frequency_offset
        k_factor = (self.state.fc_requested - fo) / self.state.fc_programmed
        dt = 0.0005 + _wrap_half_frame(rs_next.frame_timing
                                       - rs_prev.frame_timing) \
            / (self.state.fs_programmed * k_factor)
        residual_f = float(np.angle(foe_comb)) / (2 * np.pi) / dt
        residual_np = max(foe_comb_np / 2, 0.001)
        self.state.update_frequency_offset(fo + residual_f, residual_np)

    def _do_toe_v2(self, rs_prev, rs_curr, sp_curr, np_curr) -> None:
        """Staggered-RS timing estimate; update the cell frame timing."""
        if rs_prev.shift < rs_curr.shift:
            a, b = rs_prev.ce, rs_curr.ce
        else:
            a, b = rs_curr.ce, rs_prev.ce
        toe1 = np.sum(np.conj(a) * b) / 12
        toe2 = (np.sum(np.conj(b[0:5]) * a[1:6])
                + np.sum(np.conj(b[6:11]) * a[7:12])) / 10
        toe1 /= np.sqrt(sp_curr)
        toe2 /= np.sqrt(sp_curr)
        delay = -(np.angle(toe1) + np.angle(toe2)) / 2 / 3 / (2 * np.pi / 128)
        delay_np = max(np_curr / sp_curr / 2 / 12, 0.001)
        self.cell.update_frame_timing(float(delay), float(delay_np),
                                      rs_curr.frame_timing)

    def _do_ac_fd(self, rs_curr, sp_curr, np_curr) -> None:
        ac = np.array([np.mean(np.conj(rs_curr.ce[:12 - d])
                               * rs_curr.ce[d:]) for d in range(12)])
        ac = ac / sp_curr
        # Same noiseless-input guard as _do_foe: ac_np == 0 when
        # np_curr == 0; the floored blend converges to plain ac.
        ac_np = np.maximum(
            (np_curr**2 / sp_curr**2 + 2 * np_curr / sp_curr)
            / np.arange(12, 0, -1), 1e-20)
        if self.cell.ac_fd is None:
            self.cell.ac_fd = ac
        else:
            w0 = 1 / 0.00001
            self.cell.ac_fd = (self.cell.ac_fd * w0 + ac / ac_np) / (w0 + 1 / ac_np)

    def _do_ac_td(self, rs_curr, sp_curr, port: int) -> None:
        hist = self.ce_history[port]
        hist.append(rs_curr.ce)
        if len(hist) == 72:
            last = hist[71]
            xc = np.array([np.mean(np.conj(last) * hist[71 - t])
                           for t in range(72)]) / sp_curr
            if self.cell.ac_td is None:
                self.cell.ac_td = xc
            else:
                w0 = 1 / 0.00001
                self.cell.ac_td = (self.cell.ac_td * w0 + xc) / (w0 + 1)

    # ------------------------------------------------------------------
    def _interp2d(self, port: int) -> None:
        """Frequency then time linear interpolation of filtered CE.

        reference: src/tracker_thread.cpp:372-477.
        """
        cell = self.cell
        rs_prev, rs_curr = self.ce_filt_fifo[port]

        def interp72(rs):
            x = np.arange(rs.shift, 72, 6, dtype=float)
            xi = np.arange(72, dtype=float)
            idx = np.clip(np.searchsorted(x, xi, side="right") - 1, 0, 10)
            x0, x1 = x[idx], x[idx + 1]
            y0, y1 = rs.ce_filt[idx], rs.ce_filt[idx + 1]
            return y0 + (xi - x0) * (y1 - y0) / (x1 - x0)

        prev_i = interp72(rs_prev)
        curr_i = interp72(rs_curr)

        if port > 2:
            time_diff = 0.0005
        elif cell.cp_type == "extended":
            time_diff = 3 * (128 + 32) / (FS_LTE / 16)
        elif rs_prev.sym_num == 0:
            time_diff = 4 * (128 + 9) / (FS_LTE / 16)
        else:
            time_diff = (2 * (128 + 9) + (128 + 10)) / (FS_LTE / 16)

        slot_num, sym_num = rs_prev.slot_num, rs_prev.sym_num
        time_offset = 0.0
        while (slot_num, sym_num) != (rs_curr.slot_num, rs_curr.sym_num):
            a = time_offset / time_diff
            pdu = _InterpCE(
                slot_num, sym_num,
                prev_i + (curr_i - prev_i) * a,
                rs_prev.tp + (rs_curr.tp - rs_prev.tp) * a,
                rs_prev.sp + (rs_curr.sp - rs_prev.sp) * a,
                rs_prev.sp_raw + (rs_curr.sp_raw - rs_prev.sp_raw) * a,
                rs_prev.np_ + (rs_curr.np_ - rs_prev.np_) * a)
            if not self.ce_interp_init[port]:
                # Backfill CE from (0,0) up to the first RS symbol.
                self.ce_interp_init[port] = True
                tsl, tsy = 0, 0
                while (tsl, tsy) != (slot_num, sym_num):
                    self.ce_interp_fifo[port].append(dataclasses.replace(
                        pdu, slot_num=tsl, sym_num=tsy))
                    tsl, tsy = _slot_sym_inc2(cell.n_symb_dl, tsl, tsy)
            self.ce_interp_fifo[port].append(pdu)
            if cell.cp_type == "extended":
                time_offset += (128 + 32) / (FS_LTE / 16)
            else:
                time_offset += ((128 + 10) if sym_num == 6 else (128 + 9)) \
                    / (FS_LTE / 16)
            slot_num, sym_num = slot_sym_inc(cell.n_symb_dl, slot_num, sym_num)

        self.ce_filt_fifo[port].popleft()

    # ------------------------------------------------------------------
    def _update_crs_measurements(self, slot_num, sym_num, interp) -> None:
        cell = self.cell
        tp = np.array([p.tp for p in interp])
        sp_raw = np.array([p.sp_raw for p in interp])
        np_ = np.array([p.np_ for p in interp])
        if cell.crs_tp_av is None:
            cell.crs_tp_av = tp
            cell.crs_sp_raw_av = sp_raw
            cell.crs_np_av = np_
        elif slot_num in (0, 10) and sym_num in (5, 6):
            cell.crs_tp_av = 0.999 * cell.crs_tp_av + 0.001 * tp
            cell.crs_sp_raw_av = 0.999 * cell.crs_sp_raw_av + 0.001 * sp_raw
            cell.crs_np_av = 0.999 * cell.crs_np_av + 0.001 * np_

    def _sigpower_pss_sss(self, syms, slot_num, sym_num) -> None:
        """SP/NP/TP from PSS/SSS symbols incl. blank-subcarrier noise floor.

        reference: src/tracker_thread.cpp:754-820.
        """
        cell = self.cell
        n_symb_dl = cell.n_symb_dl
        if slot_num not in (0, 10) or sym_num not in (n_symb_dl - 2,
                                                      n_symb_dl - 1):
            return
        if sym_num == n_symb_dl - 2:
            self.sss_sym = syms
            return
        if self.sss_sym is None:
            return
        pss_sym = syms
        sss_sym = self.sss_sym

        def power(x):
            return float(np.mean(np.abs(x) ** 2))

        np_blank = (power(sss_sym[0:5]) + power(sss_sym[67:72])
                    + power(pss_sym[0:5]) + power(pss_sym[67:72])) / 4
        n1, n2 = divmod(cell.n_id_cell, 3)
        ce_sss = sss_sym[5:67] * sss_fd(n1, n2, 0 if slot_num == 0 else 10)
        ce_pss = pss_sym[5:67] * np.conj(pss_fd(n2))
        ce_smooth = np.empty(62, dtype=complex)
        for t in range(62):
            lt, rt = max(0, t - 6), min(t + 6, 61)
            ce_smooth[t] = (ce_sss[lt:rt + 1].sum()
                            + ce_pss[lt:rt + 1].sum()) / (2 * (rt - lt + 1))
        np_est = (power(ce_smooth - ce_sss) * 13 / 12
                  + power(ce_smooth - ce_pss) * 13 / 12) / 2
        tp = power(ce_smooth)
        sp = tp - np_est / 13
        cell.sync_tp, cell.sync_sp = tp, sp
        cell.sync_np, cell.sync_np_blank = np_est, np_blank
        cell.sync_ce = np.concatenate([np.zeros(5), ce_smooth, np.zeros(5)])
        if np.isnan(cell.sync_sp_av):
            cell.sync_tp_av, cell.sync_sp_av = tp, sp
            cell.sync_np_av, cell.sync_np_blank_av = np_est, np_blank
        else:
            cell.sync_tp_av = 0.999 * cell.sync_tp_av + 0.001 * tp
            cell.sync_sp_av = 0.999 * cell.sync_sp_av + 0.001 * sp
            cell.sync_np_av = 0.999 * cell.sync_np_av + 0.001 * np_est
            cell.sync_np_blank_av = (0.999 * cell.sync_np_blank_av
                                     + 0.001 * np_blank)

    # ------------------------------------------------------------------
    def _mib_step(self, syms, ce, sp, np_, slot_num, sym_num) -> None:
        """Collect slot-1 syms 0..3; decode every 4 frames; track health.

        reference: src/tracker_thread.cpp:531-749.
        """
        cell = self.cell
        if slot_num == 1 and sym_num <= 3:
            self.mib_fifo.append((syms, ce, np_))
        if len(self.mib_fifo) != 16:
            return

        ok = self._try_decode_mib()
        if ok:
            self.mib_fifo_synchronized = True
            cell.mib_decode_failures = 0.0
            cell.mib_decode_successes += 1
            for _ in range(16):
                self.mib_fifo.popleft()
        elif self.mib_fifo_synchronized:
            cell.mib_decode_failures += 1
            for _ in range(16):
                self.mib_fifo.popleft()
        else:
            cell.mib_decode_failures += 0.25
            for _ in range(4):
                self.mib_fifo.popleft()

        if cell.mib_decode_failures >= cell.drop_threshold:
            cell.kill_me = True

    def _try_decode_mib(self) -> bool:
        cell = self.cell
        n_syms = 960 if cell.cp_type == "normal" else 864
        v_shift_m3 = cell.n_id_cell % 3
        sc = np.arange(72)

        pbch_sym = np.empty(n_syms, dtype=complex)
        pbch_ce = np.empty((cell.n_ports, n_syms), dtype=complex)
        np_pre = np.empty((cell.n_ports, n_syms))
        idx = 0
        for fr in range(4):
            for symn in range(4):
                rs_here = symn in (0, 1) or (symn == 3
                                             and cell.cp_type == "extended")
                mask = ~((sc % 3 == v_shift_m3) & rs_here)
                syms, ce, np_ = self.mib_fifo[fr * 4 + symn]
                cnt = int(mask.sum())
                pbch_sym[idx:idx + cnt] = syms[mask]
                pbch_ce[:, idx:idx + cnt] = ce[:cell.n_ports][:, mask]
                np_pre[:, idx:idx + cnt] = np_[:cell.n_ports, None]
                idx += cnt
        assert idx == n_syms

        if cell.n_ports == 1:
            h = pbch_ce[0]
            gain = np.conj(h) / (np.abs(h) ** 2)
            syms_mib = pbch_sym * gain
            np_mib = np_pre[0] * np.abs(gain) ** 2
        else:
            x1, x2 = pbch_sym[0::2], pbch_sym[1::2]
            if cell.n_ports == 2:
                h1 = 0.5 * (pbch_ce[0, 0::2] + pbch_ce[0, 1::2])
                h2 = 0.5 * (pbch_ce[1, 0::2] + pbch_ce[1, 1::2])
                np_t = 0.5 * (np_pre[0, 0::2] + np_pre[1, 0::2])
            else:
                pairs = n_syms // 2
                use_a = (np.arange(pairs) % 2) == 0
                h1 = np.where(use_a,
                              0.5 * (pbch_ce[0, 0::2] + pbch_ce[0, 1::2]),
                              0.5 * (pbch_ce[1, 0::2] + pbch_ce[1, 1::2]))
                h2 = np.where(use_a,
                              0.5 * (pbch_ce[2, 0::2] + pbch_ce[2, 1::2]),
                              0.5 * (pbch_ce[3, 0::2] + pbch_ce[3, 1::2]))
                np_t = np.where(use_a,
                                0.5 * (np_pre[0, 0::2] + np_pre[2, 0::2]),
                                0.5 * (np_pre[1, 0::2] + np_pre[3, 0::2]))
            scale = np.abs(h1) ** 2 + np.abs(h2) ** 2
            s1 = (np.conj(h1) * x1 + h2 * np.conj(x2)) / scale
            s2 = np.conj((-np.conj(h2) * x1 + h1 * np.conj(x2)) / scale)
            syms_mib = np.empty(n_syms, dtype=complex)
            syms_mib[0::2], syms_mib[1::2] = s1, s2
            syms_mib *= np.sqrt(2.0)
            np_pair = ((np.abs(h1) / scale) ** 2
                       + (np.abs(h2) / scale) ** 2) * np_t
            np_mib = np.repeat(np_pair, 2)

        e_est = lte_demodulate(syms_mib, np_mib, "qpsk")
        e_est = np.where(self.scr == 1, -e_est, e_est)
        d_est = lte_conv_deratematch(e_est, 40)
        c_est = lte_conv_decode(d_est)
        crc_est = lte_calc_crc(c_est[:24], "crc16")
        if cell.n_ports == 2:
            crc_est = 1 - crc_est
        elif cell.n_ports == 4:
            crc_est[1::2] = 1 - crc_est[1::2]
        if not np.array_equal(crc_est, c_est[24:]):
            return False
        # Validate the MIB fields against the cell's established parameters
        # (reduces the chance of locking onto noise).
        bw = int(c_est[0]) * 4 + int(c_est[1]) * 2 + int(c_est[2])
        if N_RB_DL_TABLE.get(bw, -1) != cell.n_rb_dl:
            return False
        dur = "extended" if c_est[3] else "normal"
        if dur != cell.phich_duration:
            return False
        res = PHICH_RES_TABLE[int(c_est[4]) * 2 + int(c_est[5])]
        return res == cell.phich_resource


def _slot_sym_inc2(n_symb_dl: int, slot_num: int, sym_num: int):
    sym_num = (sym_num + 1) % n_symb_dl
    if sym_num == 0:
        slot_num = (slot_num + 1) % 20
    return slot_num, sym_num
