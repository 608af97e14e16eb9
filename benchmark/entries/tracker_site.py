"""``LTETracker`` on a multi-cell site: the tracker entry's run, judged
against the float64 search of the first ``REFERENCE_CAPTURES`` captures
of the stream that ``kalibrate`` saw instead of the first alone.

A cell is found when any of those captures finds it, with the MIB of the
first that does. The first 80 ms capture misses a site's weakest cell
(band17's -9 dB one) on about one seed in four, and any one capture on
about one in eight, while the tracker holds that cell from its
searcher's later captures; every capture searched still binds the
tracker to each cell it finds."""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark import check
from benchmark.entries.tracker import Entry as Tracker
from benchmark.reference.search import cell_search, search_sets
from benchmark.sim.playback import BLOCK_SIZE, playback
from benchmark.sim.raw import bytes_to_iq

# Five consecutive 80 ms captures (400 ms) found the -9 dB cell on every
# one of 27 seeds on the CPU; the first alone missed it on 8 of 33.
REFERENCE_CAPTURES = 5


class Entry(Tracker):
    def reference_captures(self, caplength: int, count: int) -> np.ndarray:
        """The first ``count`` captures kalibrate searched, (count,
        caplength): consecutive, as it takes them."""
        src = playback(self.site.recording, self.site.noise_power,
                       self.seed_kalibrate)
        n = -(-count * caplength // BLOCK_SIZE)
        iq = bytes_to_iq(np.concatenate([next(src) for _ in range(n)]))
        return iq[:count * caplength].reshape(count, caplength)

    def numbers(self) -> Dict[str, float]:
        cfg = self.config
        _, f_set = search_sets(cfg["fc"], cfg["fc"], cfg["ppm"])
        found = {}
        for cap in self.reference_captures(int(cfg["caplength"]),
                                           REFERENCE_CAPTURES):
            for c in cell_search(cap, cfg["fc"], f_set, interp=cfg["interp"]):
                found.setdefault(c.n_id_cell(), c)
        return check.compare_tracker(self.answers, list(found.values()))
