"""What the two search entries (``sweep``, ``serial``) share: the band's
carriers, a pool of band recordings made by the mix's generator, the
program's cells of each capture it searched, and their judgement.

The site sits on the mix's ``occupied_fc`` in the pool's first recording;
every further recording holds it on a carrier drawn from the seed in the
half of the band that the first leaves empty, so that no half of a sweep's
stack goes unjudged. The reference judges every occupied carrier of every
recording and a noise carrier drawn from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark import check
from benchmark.reference.search import cell_search, search_sets
from benchmark.reference.xcorr import n_comb_xc_for

FS = 1.92e6
NOISE_SAMPLES = 1        # noise carriers the reference judges a run


class SearchEntry:
    unit = "carriers"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 spans, gen):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans, self.gen = device, spans, gen
        self.fcs, self.f_set = search_sets(
            config["freq_start"], config["freq_end"], config["ppm"],
            config["raster_hz"])
        self.results: Dict[tuple, list] = {}
        self.pool: List[np.ndarray] = []
        self.occupied = self.place()

    def place(self) -> List[List[int]]:
        """The carriers of the site in each recording of the pool."""
        first = [int(np.argmin(np.abs(self.fcs - fc)))
                 for fc in self.traffic["occupied_fc"]]
        n = len(self.fcs)
        half = n // 2
        other = (np.arange(half, n) if all(b < half for b in first)
                 else np.arange(0, half))
        rng = np.random.default_rng([self.seed, 0x0CC])
        return [first] + [[int(rng.choice(other))]
                          for _ in range(1, int(self.traffic["pool"]))]

    def make_inputs(self) -> None:
        self.site = self.gen.draw_site(self.traffic["site"], self.seed)
        self.pool = [self.gen.band_recording(
            len(self.fcs), occ, self.site, int(self.config["caplength"]),
            self.seed, i) for i, occ in enumerate(self.occupied)]

    @property
    def shapes(self) -> Dict[str, int]:
        """The scan's shapes: fold count as the sweep takes it, the
        least over the carriers."""
        n_cap = int(self.config["caplength"])
        n_comb = min(n_comb_xc_for(n_cap - 136, self.f_set, fc, fc, FS)
                     for fc in self.fcs)
        return {"n_carriers": len(self.fcs), "n_hyp": len(self.f_set),
                "n_cap": n_cap, "n_comb": int(n_comb)}

    def sample(self) -> List[tuple]:
        """The captures the reference judges, among those the window
        searched: every occupied carrier of every recording, and noise
        carriers of a recording drawn from the seed."""
        rng = np.random.default_rng([self.seed, 0x5A3])
        seen = sorted(self.results)
        recs = sorted({r for r, _ in seen})
        rec = recs[int(rng.integers(0, len(recs)))]
        noise = [k for k in seen
                 if k[0] == rec and k[1] not in self.occupied[rec]]
        pick = [noise[i] for i in rng.permutation(len(noise))[
            :NOISE_SAMPLES]]
        occ = [(r, b) for r, bs in enumerate(self.occupied) for b in bs
               if (r, b) in self.results]
        return occ + sorted(pick)

    def capture(self, key: tuple) -> np.ndarray:
        return self.pool[key[0]][key[1]]

    def free(self) -> None:
        """The reference runs on the host: nothing of the card to free."""

    def reference(self, key: tuple) -> list:
        """The reference's cells of one capture (float64)."""
        return cell_search(self.capture(key), float(self.fcs[key[1]]),
                           self.f_set, interp=self.config["interp"])

    def numbers(self) -> Dict[str, float]:
        """The program's cells of each sampled capture against the
        reference's."""
        return check.compare_search([(self.results[key], self.reference(key))
                                     for key in self.sample()])
