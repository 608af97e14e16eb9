"""``sharded_search_sweep`` over a whole band's captures, as
``CellSearch --batch-sweep`` calls it on one card."""

from __future__ import annotations

import time
from typing import Dict

from benchmark.entries._search import SearchEntry


class Entry(SearchEntry):
    def setup(self, parts: dict) -> None:
        from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (
            all_cards_mesh, sharded_search_sweep)

        self._sweep = sharded_search_sweep
        t = time.perf_counter()
        self.make_inputs()
        parts["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        self.mesh = (all_cards_mesh(len(self.fcs))
                     if self.device.type == "cuda" else self.device)
        self.i = 0
        for _ in self.pool:          # every recording once: warm shapes
            self.step()
        parts["warmup"] = time.perf_counter() - t

    def step(self) -> Dict[str, float]:
        rec = self.i % len(self.pool)
        self.i += 1
        with self.spans.span("sweep"):
            per_cap, _ = self._sweep(
                self.pool[rec], list(self.fcs), self.f_set, device=self.mesh,
                fc_prog_list=list(self.fcs), interp=self.config["interp"])
        for b, cells in enumerate(per_cap):
            self.results[(rec, b)] = cells
        return {"carriers": len(self.fcs), "sweeps": 1}

    def end_to_end(self, units: dict, elapsed: float) -> Dict[str, float]:
        return {"sweep_carriers_per_s": units["carriers"] / elapsed}
