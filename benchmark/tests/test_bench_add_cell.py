"""A configuration, a traffic mix with a new kind of entry and a new
generator, an end-to-end metric, a per-layer metric and a cell are added
as new files and manifest entries, with no file of the benchmark edited,
and the harness runs the new cell (on the CPU, at a tiny size)."""

import hashlib
import json
import shutil

from benchmark.harness import run_cell
from benchmark.manifest import ROOT
from benchmark.tests.tiny import SEED

ENTRY = '''"""cell_search carrier by carrier; the median latency."""
import numpy as np

from benchmark.entries.serial import Entry as Serial


class Entry(Serial):
    def end_to_end(self, units, elapsed):
        return {"search_ms_p50":
                float(np.percentile(np.asarray(self.latency) * 1e3, 50))}
'''
GENERATOR = '''"""The site of site.py with nothing on its free resource elements."""
from benchmark.sim import site

band_recording = site.band_recording


def draw_site(spec, seed):
    return site.draw_site(dict(spec, load_factor=0.0), seed)
'''
READER = '''def read(win):
    n = win.units.get("carriers", 0)
    return 1e3 * win.spans["cell_search"] / n if n else None
'''


def digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_cell_from_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path)
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "band17.json").read_text())
    config.update(freq_start=739.0e6, freq_end=739.1e6, ppm=10)
    (b / "configs" / "band17_edge.json").write_text(json.dumps(config))
    mix = json.loads((b / "traffic" / "serial.json").read_text())
    mix.update(entry="serial_p50", generator="site_quiet", pool=1)
    (b / "traffic" / "serial_quiet.json").write_text(json.dumps(mix))
    (b / "entries" / "serial_p50.py").write_text(ENTRY)
    (b / "sim" / "site_quiet.py").write_text(GENERATOR)
    (b / "metrics" / "search.host_ms_per_capture.py").write_text(READER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = "band17edge.serial_quiet"
    bench["configs"].append({"name": "band17edge", "source": "x",
                             "file": "benchmark/configs/band17_edge.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "band17edge",
                               "traffic": "serial_quiet", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({
        "name": "search_ms_p50", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock", "workloads": [cell]})
    bench["per_layer"].append({
        "name": "search.host_ms_per_capture", "unit": "ms",
        "better": "lower", "source": "host_clock",
        "layer": "search entry (search/cell_search.py)",
        "moves": "search_ms_p50", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    traced = run_cell(cell, SEED, 0.5, True, device="cpu", root=tmp_path)
    assert traced.correct, traced.checks
    assert traced.metrics["search.host_ms_per_capture"]["value"] > 0
    plain = run_cell(cell, SEED, 0.5, False, device="cpu", root=tmp_path)
    assert plain.correct, plain.checks
    assert set(plain.metrics) == {"search_ms_p50", "setup_s"}
    after = digest(tmp_path)
    assert all(after[k] == v for k, v in before.items())
