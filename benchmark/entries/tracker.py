"""``LTETracker`` as ``LTE-Tracker`` runs it on one carrier, fed the
site's recording with fresh AWGN through the dongle's quantizer (the
CLI's file playback): ``kalibrate``, then ``run`` in chunks of the CLI's
``BLOCKS_PER_STATUS`` blocks, each followed by ``render_status`` (its
text goes to no terminal)."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark import check
from benchmark.reference.search import cell_search, search_sets
from benchmark.sim.playback import BLOCK_SIZE, playback
from benchmark.sim.raw import bytes_to_iq

FS = 1.92e6
MIB_PERIOD_S = 0.04
# Chunks run in set-up once kalibrate has found the cells: the first
# chunk after acquisition runs ~1.8x slower than the next.
ACQUIRE_CHUNKS = 2


class Entry:
    unit = "blocks"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 spans, gen):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans, self.gen = device, spans, gen
        self.seed_kalibrate = [seed, 1]
        self.seed_window = [seed, 2]

    @property
    def shapes(self) -> Dict[str, int]:
        return {"n_cells": len(self.traffic["site"]["cells"])}

    def setup(self, parts: dict) -> None:
        from lte_cell_scanner_tpu_torch.tracker.display import render_status
        from lte_cell_scanner_tpu_torch.tracker.runtime import LTETracker

        self._render = render_status
        cfg = self.config
        t = time.perf_counter()
        self.site = self.gen.draw_site(self.traffic["site"], self.seed)
        parts["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        self.events: List[tuple] = []
        self.trk = LTETracker(
            cfg["fc"], engine_every=int(cfg["engine_every"]),
            feeder=cfg["feeder"], device=self.device,
            on_event=lambda kind, info: self.events.append((kind, info)))
        self.trk.kalibrate(playback(self.site.recording,
                                    self.site.noise_power,
                                    self.seed_kalibrate),
                           ppm=cfg["ppm"], correction=1.0)
        parts["kalibrate"] = time.perf_counter() - t
        t = time.perf_counter()
        self.src = playback(self.site.recording, self.site.noise_power,
                            self.seed_window)
        for _ in range(ACQUIRE_CHUNKS):
            self.step()
        self.mib_start = self._mib()
        parts["acquire"] = time.perf_counter() - t

    def instrument(self) -> None:
        """Spans around the engine, the feeder and the searcher."""
        trk = self.trk
        if trk.engine is not None:
            self.spans.wrap(trk.engine, "process_all", "engine")
        self.spans.wrap(trk.feeder, "feed", "feeder")
        if hasattr(trk.feeder, "feed_bytes"):
            self.spans.wrap(trk.feeder, "feed_bytes", "feeder")
        self.spans.wrap(trk, "_run_searcher", "searcher")

    def step(self) -> Dict[str, float]:
        n = int(self.config["blocks_per_status"])
        got = self.trk.run(self.src, max_blocks=n)
        self._render(self.trk.status(), expert=False, tracker=self.trk)
        return {"blocks": got, "signal_s": got * BLOCK_SIZE / FS}

    def end_to_end(self, units: dict, elapsed: float) -> Dict[str, float]:
        return {"tracker_realtime_x": units["signal_s"] / elapsed}

    def _mib(self) -> Dict[tuple, int]:
        return {(c.n_id_cell, c.serial_num): c.mib_decode_successes
                for c in self.trk.cells if not c.kill_me}

    def finish(self, units: dict) -> None:
        """Read the tracker's answers once the window has closed. The
        frequency offset and frame timings are kept for the log; they are
        not compared (PERF.md)."""
        end = self._mib()
        self.answers = {
            "frequency_offset": float(self.trk.state.frequency_offset),
            "cells": [dict(pci=c.n_id_cell, n_ports=c.n_ports,
                           cp_type=c.cp_type, n_rb_dl=c.n_rb_dl,
                           phich_duration=c.phich_duration,
                           phich_resource=c.phich_resource,
                           frame_timing=float(c.frame_timing),
                           mib_in_window=end[(c.n_id_cell, c.serial_num)]
                           - self.mib_start.get((c.n_id_cell, c.serial_num),
                                                0))
                      for c in self.trk.cells if not c.kill_me],
            "periods": int(units.get("signal_s", 0.0) / MIB_PERIOD_S),
            "tracked": len(self.trk.cells),
            "acquired": sum(k == "cell_acquired" for k, _ in self.events),
            "dropped": sum(k == "cell_dropped" for k, _ in self.events),
        }

    def reference_capture(self, caplength: int) -> np.ndarray:
        """The first capture kalibrate searched: the same samples."""
        src = playback(self.site.recording, self.site.noise_power,
                       self.seed_kalibrate)
        n = -(-caplength // BLOCK_SIZE)
        raw = np.concatenate([next(src) for _ in range(n)])
        return bytes_to_iq(raw)[:caplength]

    def free(self) -> None:
        self.trk = None
        self.src = None

    def numbers(self) -> Dict[str, float]:
        """The tracker's answers against the reference's cells of the
        first capture."""
        cfg = self.config
        _, f_set = search_sets(cfg["fc"], cfg["fc"], cfg["ppm"])
        ref = cell_search(self.reference_capture(int(cfg["caplength"])),
                          cfg["fc"], f_set, interp=cfg["interp"])
        return check.compare_tracker(self.answers, ref)
