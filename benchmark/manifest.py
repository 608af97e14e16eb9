"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the ``file`` of its ``configs`` entry; its
traffic mix is ``traffic/<traffic>.json``, which names its entry and its
generator (``entries/__init__.py``); each per-layer metric that lists the
cell (or lists no cells) is read by ``metrics/<name>.py``, or, where
there is none, by ``metrics/<what follows the first dot>.py``: one
reader serves ``sweep.device_idle`` and ``tracker.device_idle``. Adding a
cell, a configuration, a mix or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, with "name"
    traffic: dict         # the mix's file, with "name"
    end_to_end: List[dict]
    per_layer: List[dict]


def load_module(path: Path):
    """Import a Python file by path (a name may hold dots). The module is
    registered under ``benchmark._loaded.<folder>.<name>``, so that what
    it defines (dataclasses) finds its module."""
    name = "benchmark._loaded.{}.{}".format(path.parent.name,
                                            path.stem.replace(".", "_"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration and
    mix read, its metrics chosen."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(json.loads((root / conf["file"]).read_text()),
                  name=conf["name"])
    traffic = dict(json.loads(
        (root / "benchmark" / "traffic" / f"{w['traffic']}.json")
        .read_text()), name=w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def reader_path(name: str, root: Path = ROOT) -> Path:
    """The reader of the per-layer metric ``name``."""
    here = root / "benchmark" / "metrics"
    own = here / f"{name}.py"
    return own if own.exists() else here / f"{name.split('.', 1)[-1]}.py"


def metric_readers(cell: Cell, root: Path = ROOT) -> Dict[str, object]:
    """``read`` of each of the cell's per-layer metrics, by name."""
    return {m["name"]: load_module(reader_path(m["name"], root)).read
            for m in cell.per_layer}
