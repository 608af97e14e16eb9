"""``wideband_search_sweep`` over one sc16 recording of a whole band, as
``CellSearch --wideband REC --wideband-sc16`` calls it on one card: the
host int16 recording in, every raster carrier's cells out, so that the
upload, the channelizer and the batched sweep are timed together. One
step is one sweep, back to back in a closed loop.

The pool's recordings hold the same sites on the mix's carriers
(``sites``), each with offsets and timings of its own. The reference
channelizes each carrier it judges from the definition
(:mod:`benchmark.reference.channelize`, float64) and searches the channel
(:mod:`benchmark.reference.search`): every occupied carrier of every
recording, and a noise carrier drawn from the seed, one whose channel no
site reaches.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark.entries._search import FS, NOISE_SAMPLES, SearchEntry
from benchmark.reference.channelize import channelize, decimation_fir
from benchmark.reference.search import cell_search

# A noise carrier lies this far from every occupied one: a site's 1.08
# MHz beside the FIR's stopband edge, 1.32 MHz from the channel's centre.
NOISE_CLEARANCE_HZ = 2.0e6


class Entry(SearchEntry):
    def place(self) -> List[List[int]]:
        """The occupied carriers of the band, the same in every
        recording."""
        occ = [int(np.argmin(np.abs(self.fcs - s["fc"])))
               for s in self.traffic["sites"]
               if self.fcs[0] <= s["fc"] <= self.fcs[-1]]
        return [occ for _ in range(int(self.traffic["pool"]))]

    @property
    def decim(self) -> int:
        return int(round(self.config["fs_in"] / FS))

    @property
    def shapes(self) -> Dict[str, int]:
        """The scan's shapes, and the channelizer's: the recording's
        length and the FIR's taps."""
        c = self.config
        return dict(super().shapes, fir_taps=len(decimation_fir(self.decim)),
                    n_wide=(int(c["caplength"]) + int(c["fir_tail"]))
                    * self.decim)

    def make_inputs(self) -> None:
        c = self.config
        n_wide = self.shapes["n_wide"]
        self.pool = []
        for i in range(int(self.traffic["pool"])):
            sites = self.gen.draw_sites(self.traffic["sites"],
                                        self.traffic["site"], self.seed, i)
            self.pool.append(self.gen.wide_recording(
                sites, c["fs_in"], c["fc_center"], n_wide, self.seed, i,
                float(self.traffic["full_scale_share"])))

    def setup(self, parts: dict) -> None:
        from lte_cell_scanner_tpu_torch.parallel.fc_sweep import \
            all_cards_mesh
        from lte_cell_scanner_tpu_torch.search.wideband import \
            wideband_search_sweep

        self._sweep = wideband_search_sweep
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
        with self.spans.span("wideband"):
            per_cap, _ = self._sweep(
                self.pool[rec], self.config["fs_in"],
                self.config["fc_center"], list(self.fcs), self.f_set,
                device=self.mesh, interp=self.config["interp"])
        for b, cells in enumerate(per_cap):
            self.results[(rec, b)] = cells
        return {"carriers": len(self.fcs), "sweeps": 1}

    def end_to_end(self, units: dict, elapsed: float) -> Dict[str, float]:
        return {"sweep_carriers_per_s": units["carriers"] / elapsed}

    def sample(self) -> List[tuple]:
        """Every occupied carrier of every recording the window searched,
        and noise carriers of a recording drawn from the seed."""
        rng = np.random.default_rng([self.seed, 0x5A3])
        seen = sorted(self.results)
        recs = sorted({r for r, _ in seen})
        rec = recs[int(rng.integers(0, len(recs)))]
        occupied = [s["fc"] for s in self.traffic["sites"]]
        noise = [k for k in seen if k[0] == rec and all(
            abs(self.fcs[k[1]] - fc) >= NOISE_CLEARANCE_HZ
            for fc in occupied)]
        pick = [noise[i] for i in rng.permutation(len(noise))[
            :NOISE_SAMPLES]]
        occ = [(r, b) for r, bs in enumerate(self.occupied) for b in bs
               if (r, b) in self.results]
        return occ + sorted(pick)

    def reference(self, key: tuple) -> list:
        """The reference's cells of one carrier: its channel from the
        definition, then the float64 search."""
        c = self.config
        fc = float(self.fcs[key[1]])
        channel = channelize(self.pool[key[0]], c["fs_in"], c["fc_center"],
                             fc, int(c["caplength"]))
        return cell_search(channel, fc, self.f_set, interp=c["interp"])
