"""``cell_search`` on one numpy capture at a time, carrier after carrier,
as ``CellSearch`` calls it by default."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark.entries._search import SearchEntry


class Entry(SearchEntry):
    def setup(self, parts: dict) -> None:
        from lte_cell_scanner_tpu_torch.search.cell_search import cell_search

        self._search = cell_search
        t = time.perf_counter()
        self.make_inputs()
        parts["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        # Warm both paths of every recording: an occupied carrier (decode)
        # and a noise carrier (scan and peaks only).
        for rec, occ in enumerate(self.occupied):
            noise = next(b for b in range(len(self.fcs)) if b not in occ)
            for b in (occ[0], noise):
                self._one(rec, b)
        self.results.clear()
        self.order = [(r, b) for r in range(len(self.pool))
                      for b in range(len(self.fcs))]
        self.i = 0
        self.latency: List[float] = []
        parts["warmup"] = time.perf_counter() - t

    def _one(self, rec: int, b: int) -> float:
        fc = float(self.fcs[b])
        t0 = time.perf_counter()
        with self.spans.span("cell_search"):
            cells = self._search(self.pool[rec][b], fc, fc,
                                 f_search_set=self.f_set,
                                 interp=self.config["interp"],
                                 device=self.device)
        dt = time.perf_counter() - t0
        self.results[(rec, b)] = cells
        return dt

    def step(self) -> Dict[str, float]:
        rec, b = self.order[self.i % len(self.order)]
        self.i += 1
        self.latency.append(self._one(rec, b))
        return {"carriers": 1}

    def end_to_end(self, units: dict, elapsed: float) -> Dict[str, float]:
        return {"search_ms_p95":
                float(np.percentile(np.asarray(self.latency) * 1e3, 95))}
