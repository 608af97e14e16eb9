"""Capture front end: record and replay of 80 ms capture buffers, and the
tuner model.

Counterpart of lte_cell_scanner_tpu/io/capture.py (reference:
src/capbuf.cpp, capture_data: a live rtlsdr capture or a capbuf_XXXX.it
replay, optionally recorded; src/from_osmocom.cpp, compute_fc_programmed:
the E4000 tuner's integer PLL, so that the exact programmed LO frequency
is known). Host code only: no device work happens here.

Live SDR hardware is optional: the "rtlsdr" backend imports pyrtlsdr
when it is constructed and raises RuntimeError without it. The replay
("file") backend is what the reference's own integration tests use; the
"simulator" backend makes captures with the built-in eNodeB.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np

from lte_cell_scanner_tpu_torch.constants import CAPLENGTH
from lte_cell_scanner_tpu_torch.io.itfile import load_it, save_it

# ----------------------------------------------------------------------
# E4000 PLL model (the integer arithmetic of the osmocom E4000 tuner code,
# reference: src/from_osmocom.cpp:47-166).

_E4K_PLL_Y = 65536
# (upper LO frequency in Hz, three-phase flag << 3 | index, multiplier R)
_PLL_VARS = [
    (72_400_000, (1 << 3) | 7, 48),
    (81_200_000, (1 << 3) | 6, 40),
    (108_300_000, (1 << 3) | 5, 32),
    (162_500_000, (1 << 3) | 4, 24),
    (216_600_000, (1 << 3) | 3, 16),
    (325_000_000, (1 << 3) | 2, 12),
    (350_000_000, (1 << 3) | 1, 8),
    (432_000_000, (0 << 3) | 3, 8),
    (667_000_000, (0 << 3) | 2, 6),
    (1_200_000_000, (0 << 3) | 1, 4),
]


def compute_fc_programmed(fosc: float, intended_flo: float) -> float:
    """The exact LO frequency the E4000 tuner programs for a requested
    one."""
    r = 2
    for freq, _synth, mult in _PLL_VARS:
        if intended_flo < freq:
            r = mult
            break
    fosc_i = int(fosc)
    intended_fvco = int(intended_flo) * r
    z = intended_fvco // fosc_i
    remainder = intended_fvco - fosc_i * z
    x = (remainder * _E4K_PLL_Y) // fosc_i
    fvco = fosc_i * z + (fosc_i * x) // _E4K_PLL_Y
    return float(fvco // r)


def fs_programmed_rtl2832(fs_requested: float, xtal: float = 28.8e6) -> float:
    """The exact sample rate the RTL2832 programs: divider =
    round(xtal 2^22 / fs) with its low 2 bits cleared (reference:
    src/LTE-Tracker.cpp:442-537)."""
    divider = int(round(xtal * (1 << 22) / fs_requested)) & ~3
    return xtal * (1 << 22) / divider


# ----------------------------------------------------------------------
# Record and replay.


def capbuf_path(data_dir: str, capture_number: int) -> str:
    return os.path.join(data_dir, f"capbuf_{capture_number:04d}.it")


def load_capbuf(data_dir: str, capture_number: int,
                fc_requested: Optional[float] = None
                ) -> Tuple[np.ndarray, float]:
    """Replay a recorded capture; returns (capbuf, fc_programmed).

    Recordings made here carry the programmed (tuner-quantized) frequency
    in an extra "fc_programmed" field, so that a replay reproduces the
    live run's k_factor arithmetic exactly; the reference's recordings
    only have "fc" (= fc_requested), which is then the best value there
    is.
    """
    d = load_it(capbuf_path(data_dir, capture_number))
    fc_file = float(d["fc"][0])
    if fc_requested is not None and fc_requested != fc_file:
        warnings.warn(
            f"capture {capture_number}: file fc {fc_file / 1e6:.4g} MHz does "
            f"not match requested {fc_requested / 1e6:.4g} MHz")
    fc_programmed = (float(d["fc_programmed"][0]) if "fc_programmed" in d
                     else fc_file)
    return d["capbuf"], fc_programmed


def save_capbuf(data_dir: str, capture_number: int, capbuf: np.ndarray,
                fc_requested: float,
                fc_programmed: Optional[float] = None) -> str:
    """Record a capture.

    fc is an int32 ivec whenever it fits, byte-compatible with the
    reference's recordings (src/capbuf.cpp:187-197). int32 overflows above
    2.147 GHz (LTE bands 7/38/41/42): those carriers fall back to a
    float64 dvec, which only this project reads. The exact tuned frequency
    travels in the extra float64 "fc_programmed" field.
    """
    path = capbuf_path(data_dir, capture_number)
    fc_int = int(round(fc_requested))
    if abs(fc_requested - fc_int) < 0.5 and fc_int < 2 ** 31:
        fc_field = np.array([fc_int], dtype=np.int32)
    else:
        fc_field = np.array([float(fc_requested)], dtype=np.float64)
    fields = {"capbuf": np.asarray(capbuf, dtype=np.complex128),
              "fc": fc_field}
    if fc_programmed is not None:
        fields["fc_programmed"] = np.array([float(fc_programmed)],
                                           dtype=np.float64)
    save_it(path, fields)
    return path


class CaptureSource:
    """Sequential captures from one of three backends, optionally
    recorded:

    - "file": replay capbuf_XXXX.it from ``data_dir`` in order;
    - "simulator": the built-in eNodeB (keyword arguments go to
      ``synthetic_capture``);
    - "rtlsdr": live hardware through pyrtlsdr, if it is installed
      (RuntimeError otherwise).
    """

    def __init__(self, backend: str = "file", data_dir: str = ".",
                 record: bool = False, correction: float = 1.0,
                 tuner: str = "", device_index: int = 0, **sim_kwargs):
        if backend not in ("file", "simulator", "rtlsdr"):
            raise ValueError(f"unknown capture backend {backend!r}")
        self.backend = backend
        self.data_dir = data_dir
        self.record = record
        self.correction = correction
        self.tuner = tuner
        self.sim_kwargs = sim_kwargs
        self.capture_number = 0
        self._sdr = None
        if backend == "rtlsdr":
            try:
                from rtlsdr import RtlSdr  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "the rtlsdr backend needs the pyrtlsdr package and an "
                    "RTL2832 dongle; use backend 'file' or 'simulator'"
                ) from e
            self._sdr = RtlSdr(device_index)
            self._sdr.sample_rate = round(1.92e6 * correction)
            self._sdr.gain = "auto"
            self._agc_settled = False

    def capture(self, fc_requested: float) -> Tuple[np.ndarray, float]:
        """One 80 ms capture: (capbuf, fc_programmed)."""
        if self.backend == "file":
            capbuf, fc_programmed = load_capbuf(
                self.data_dir, self.capture_number, fc_requested)
        elif self.backend == "simulator":
            from lte_cell_scanner_tpu_torch.io.simulator import \
                synthetic_capture

            capbuf = synthetic_capture(**self.sim_kwargs)
            fc_programmed = fc_requested
        else:
            capbuf, fc_programmed = self._capture_sdr(fc_requested)
        if self.record and self.backend != "file":
            save_capbuf(self.data_dir, self.capture_number, capbuf,
                        fc_requested, fc_programmed=fc_programmed)
        self.capture_number += 1
        return capbuf, fc_programmed

    def _capture_sdr(self, fc_requested: float):
        # Tuning can fail transiently: 5 tries, 1 s apart (reference
        # src/CellSearch.cpp:389-398).
        for attempt in range(5):
            try:
                self._sdr.center_freq = round(fc_requested * self.correction)
                break
            except OSError:
                if attempt == 4:
                    raise
                print("Unable to set center frequency... retrying...")
                time.sleep(1.0)
        if not self._agc_settled:
            # Drop ~1.5 s of samples so that the AGC settles before the
            # first capture (reference src/CellSearch.cpp:413-433).
            n_drop = 0
            while n_drop < 2_880_000:
                n_drop += len(self._sdr.read_samples(16 * 16384))
            self._agc_settled = True
        capbuf = np.asarray(self._sdr.read_samples(CAPLENGTH),
                            dtype=np.complex128)
        if self.tuner.lower() == "e4000":
            # +58 Hz empirical offset, reference src/capbuf.cpp:145-149.
            return capbuf, compute_fc_programmed(28.8e6, fc_requested) + 58
        return capbuf, fc_requested
