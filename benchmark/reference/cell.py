"""The accumulating cell-detection result record.

reference: include/common.h.in:101-129 and src/common.cpp:29-106 — fields are
filled in progressively as a candidate peak passes each pipeline stage:

    xcorr_pss/peak_search : fc_requested fc_programmed pss_pow ind freq n_id_2
    sss_detect            : n_id_1 cp_type frame_start
    pss_sss_foe           : freq_fine
    tfoec                 : freq_superfine
    decode_mib            : n_ports n_rb_dl phich_duration phich_resource sfn
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class Cell:
    # Filled by peak_search
    fc_requested: float = float("nan")
    fc_programmed: float = float("nan")
    fs_programmed: float = float("nan")
    pss_pow: float = float("nan")
    ind: float = float("nan")  # PSS start offset in the capture buffer
    freq: float = float("nan")  # coarse frequency offset (Hz)
    n_id_2: int = -1
    # Filled by sss_detect
    n_id_1: int = -1
    cp_type: str = ""  # "normal" | "extended" | "" (unknown)
    frame_start: float = float("nan")
    # Filled by pss_sss_foe
    freq_fine: float = float("nan")
    # Filled by tfoec
    freq_superfine: float = float("nan")
    # Filled by decode_mib
    n_ports: int = -1
    n_rb_dl: int = -1
    phich_duration: str = ""  # "normal" | "extended"
    phich_resource: float = float("nan")  # 1/6, 1/2, 1, 2
    sfn: int = -1

    def n_id_cell(self) -> int:
        """Physical cell identity = 3*n_id_1 + n_id_2."""
        if self.n_id_1 < 0 or self.n_id_2 < 0:
            return -1
        return 3 * self.n_id_1 + self.n_id_2

    @property
    def n_symb_dl(self) -> int:
        if self.cp_type == "normal":
            return 7
        if self.cp_type == "extended":
            return 6
        raise ValueError(f"cp_type not determined yet: {self.cp_type!r}")

    def k_factor(self, freq: Optional[float] = None) -> float:
        """Sample-clock correction factor for a frequency-offset hypothesis.

        fc_programmed*k_factor is the receiver's true RX center frequency;
        fs_programmed*k_factor is the true sample rate.
        (reference: src/searcher.cpp:18-43)
        """
        f = self.freq if freq is None else freq
        return (self.fc_requested - f) / self.fc_programmed

    def __str__(self) -> str:  # progressive printout, like the reference
        lines = [f"fc={self.fc_requested / 1e6:.4g}MHz pss_pow={self.pss_pow:.4g} "
                 f"ind={self.ind} freq={self.freq:+.0f}Hz n_id_2={self.n_id_2}"]
        if self.n_id_1 >= 0:
            lines.append(
                f"n_id_1={self.n_id_1} (cell {self.n_id_cell()}) cp={self.cp_type} "
                f"frame_start={self.frame_start:.2f}"
            )
        if not math.isnan(self.freq_fine):
            lines.append(f"freq_fine={self.freq_fine:+.1f}Hz")
        if not math.isnan(self.freq_superfine):
            lines.append(f"freq_superfine={self.freq_superfine:+.2f}Hz")
        if self.n_rb_dl > 0:
            lines.append(
                f"MIB: n_ports={self.n_ports} n_rb_dl={self.n_rb_dl} "
                f"phich={self.phich_duration}/{self.phich_resource} sfn={self.sfn}"
            )
        return "\n".join(lines)
