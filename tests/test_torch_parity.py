"""The port does everything the JAX package does: a walk of both trees.

For every module of lte_cell_scanner_tpu/ the walk reads, with ``ast``,
its public definitions (functions, classes with their public methods and
fields, module constants) and each function's parameters, the flags its
``argparse`` parsers add, and for a tool (tools/) the string keys of its
dicts and the strings of its public tuple constants (the names it accepts
and prints). Each must have a counterpart in the port's module at the same
path (lte_cell_scanner_tpu_torch/), under the same name or under the name
:data:`RENAMED` gives; otherwise it stands on :data:`JAX_ONLY` with its
reason. Private names (a leading underscore: the JAX package's ``*_jit``
wrappers, ``_bucket``, ``_LazyArray``, ``_table_cache_dir``) are not
walked. Every entry of the lists must still be needed, so the lists cannot
outgrow the differences. The second test imports each port module first in
a fresh set of modules, and each subpackage exports its JAX counterpart's
names.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "lte_cell_scanner_tpu"
PORT = REPO / "lte_cell_scanner_tpu_torch"

# JAX modules whose counterpart has another name: the framework's suffix
# (_jax -> _torch) or a Pallas kernel's module -> its CUDA kernel's wrapper.
MODULES = {
    "models/viterbi_pallas.py": "models/viterbi.py",
    "ops/fd_demod_pallas.py": "ops/fd_demod.py",
    "ops/xcorr_pallas.py": "ops/xcorr_torch.py",
    "ops/mib_jax.py": "ops/mib_torch.py",
    "ops/peak_jax.py": "ops/peak_torch.py",
    "ops/sync_jax.py": "ops/sync_torch.py",
}

# Items the port has under another name (an item is "path:name", a
# parameter "path:function(name)").
RENAMED = {
    # The Pallas kernels' entry points -> the CUDA kernels' wrappers.
    "models/viterbi_pallas.py:lte_conv_decode_pallas":
        "lte_conv_decode_batch",
    "models/viterbi_pallas.py:lte_conv_decode_pallas_tl": "viterbi_tl",
    "ops/fd_demod_pallas.py:fd_demod_pallas": "fd_demod",
    "ops/fd_demod_pallas.py:fd_demod_pallas(foc_rate)": "foc",
    "ops/xcorr_pallas.py:xcorr_fold_pallas": "xcorr_fold",
    "ops/xcorr_pallas.py:xcorr_fold_pallas(tpl_bank)": "tpl",
    "ops/xcorr_pallas.py:xcorr_core_pallas": "xcorr_core",
    "ops/xcorr_pallas.py:scan_plan(capbuf_len)": "n_cap",
    # The device capture: a torch tensor the caller uploads.
    "ops/mib_jax.py:decode_mib_batch(cap_dev)": "cap",
    "ops/mib_jax.py:extract_tfg_batch(cap_dev)": "cap",
    "ops/sync_jax.py:sss_foe_batch(cap_dev)": "cap",
    # A jax Mesh -> a device or a CapMesh (parallel/fc_sweep.py).
    "parallel/fc_sweep.py:sharded_fc_sweep(mesh)": "device",
    "parallel/fc_sweep.py:sharded_search_sweep(mesh)": "device",
    "search/pipeline.py:pipelined_search_sweep(mesh)": "device",
    "search/wideband.py:wideband_search_sweep(mesh)": "device",
    # Module constants (B from the environment) -> flags.
    "tools/profile_pipeline.py:B": "--batch",
    "tools/profile_pipeline.py:REPS": "--reps",
    # The deferred decode's cells travel in its plan.
    "ops/mib_jax.py:MibPending.cells": "MibPlan.cells",
    # profile_pipeline's stages -> the pipeline's tracer spans (a string
    # of search/pipeline.py; "pipe.tables" also turns the tables into
    # candidates).
    "tools/profile_pipeline.py['upload_wait']":
        "search/pipeline.py['pipe.upload']",
    "tools/profile_pipeline.py['scan_dispatch']":
        "search/pipeline.py['pipe.scan']",
    "tools/profile_pipeline.py['tables_fetch']":
        "search/pipeline.py['pipe.tables']",
    "tools/profile_pipeline.py['peaks_to_cells']":
        "search/pipeline.py['pipe.tables']",
    "tools/profile_pipeline.py['sync_plan_dispatch']":
        "search/pipeline.py['pipe.sync_dispatch']",
    "tools/profile_pipeline.py['finish_sync']":
        "search/pipeline.py['pipe.sync_collect']",
    "tools/profile_pipeline.py['mib_plan_dispatch']":
        "search/pipeline.py['pipe.mib_dispatch']",
    "tools/profile_pipeline.py['finish_mib']":
        "search/pipeline.py['pipe.mib_collect']",
}

# What the port leaves out on purpose: JAX-only twins and TPU workarounds.
JAX_ONLY = {
    # JAX-only twins.
    "models/convcode_jax.py": "the XLA Viterbi beside the Pallas kernel; "
                              "the port has one decoder (models/viterbi.py) "
                              "and its plain version",
    "ops/xcorr_jax.py": "the scan as XLA ops beside the Pallas kernels; the "
                        "port's plain versions sit beside its kernels "
                        "(ops/xcorr_torch.py)",
    "tools/bench_wideband.py:measure_channelizer":
        "a lax.scan slope of the channelizer; the port times it with CUDA "
        "events in bench_wideband.main",
    "ops/peak_jax.py:scan_and_peaks_pallas":
        "the Pallas scan and the greedy peaks fused into one XLA program; "
        "the port launches xcorr_core, then peak_search_device",
    "ops/xcorr_pallas.py:xcorr_single_pallas":
        "a host-facing Pallas helper for the JAX tests and bench; the "
        "port's is xcorr_core on a device tensor",
    # Pallas's block layout and interpret mode: a CUDA wrapper takes the
    # capture and the starts (its kernel gathers and tiles in its warp
    # layout, csrc/xcorr_fold.cu:106-107), and a CPU tensor's plain version.
    "ops/xcorr_pallas.py:DEFAULT_TILE": "a Pallas block width",
    "ops/xcorr_pallas.py:WIN_ROWS": "a Pallas block's window rows",
    "ops/xcorr_pallas.py:WIN_PAD": "a Pallas block's window padding",
    "ops/xcorr_pallas.py:plan_tiles": "the Pallas grid's tile schedule",
    "ops/xcorr_pallas.py:plan_tiles_tea": "the Pallas grid's tile schedule",
    "ops/xcorr_pallas.py:pad_capture": "padding to the Pallas tile grid",
    "ops/xcorr_pallas.py:scan_plan(tile)": "a Pallas block width",
    "ops/xcorr_pallas.py:xcorr_fold_pallas(bases, offs, tile, halo, n_tile, "
    "interpret)": "the Pallas tile schedule and interpret mode",
    "ops/xcorr_pallas.py:xcorr_core_pallas(bank, bases, offs, n_comb_xc, "
    "n_comb_sp, tile, halo, n_tile, interpret)":
        "the Pallas tile schedule and interpret mode (the port's plan "
        "carries the bank and the fold counts)",
    "ops/fd_demod_pallas.py:fd_demod_pallas(yr, yi, yr2, yi2, b, mats, "
    "pre_bpo, interpret)":
        "pre-gathered planar rows, dense DFT matrices for the MXU, the mode "
        "as a flag and interpret mode; the CUDA wrapper takes the capture, "
        "the starts and a named DFT, one entry per mode",
    "ops/fd_demod_pallas.py:planar_rows": "the Pallas kernel's pre-gathered "
                                          "planar rows",
    "ops/fd_demod_pallas.py:planar_rows_f32": "the Pallas kernel's "
                                              "pre-gathered planar rows",
    "models/viterbi_pallas.py:lte_conv_decode_pallas(interpret)":
        "Pallas's interpret mode",
    "models/viterbi_pallas.py:lte_conv_decode_pallas_tl(interpret)":
        "Pallas's interpret mode",
    "tools/bench_scan.py --tile": "a Pallas block width",
    "tools/bench_decode.py:STAGES['wins']":
        "a cut after the window gather, which the CUDA kernel does inside "
        "K4",
    # XLA's static shapes: batches padded to buckets, fixed axes.
    "ops/mib_jax.py:mib_plan(bucket)": "XLA shape buckets",
    "ops/sync_jax.py:sync_plan(bucket)": "XLA shape buckets",
    "ops/sync_jax.py:N_SSS": "a static axis for XLA; the port sizes it per "
                             "capture",
    # The JAX device path's host upload, and fc/fs that it deletes unused
    # (both packages take them from each cell).
    "ops/mib_jax.py:mib_plan(fc_requested, fc_programmed, fs_programmed)":
        "unused by the JAX function (del): fc/fs are per cell",
    "ops/sync_jax.py:sync_plan(fc_requested, fc_programmed, fs_programmed)":
        "unused by the JAX function (del): fc/fs are per cell",
    "ops/mib_jax.py:decode_mib_batch(capbuf, fc_requested, fc_programmed, "
    "fs_programmed)": "the JAX upload of the host capture; fc/fs unused",
    "ops/mib_jax.py:extract_tfg_batch(capbuf, fc_requested, fc_programmed, "
    "fs_programmed)": "the JAX upload of the host capture; fc/fs unused",
    "ops/sync_jax.py:sss_foe_batch(capbuf, fc_requested, fc_programmed, "
    "fs_programmed)": "the JAX upload of the host capture; fc/fs unused",
    # XLA dispatch choices of the sweeps.
    "parallel/fc_sweep.py:sharded_fc_sweep(use_pallas, return_tables)":
        "the XLA scan's fallback and a debug output; the port's StackScan "
        "keeps the tables",
    "parallel/fc_sweep.py:tables_to_peaks(capbufs, ds_comb_arm, "
    "max_peaks)": "the host rescan's inputs; the port's StackScan redoes "
                  "full tables on the card",
    "search/pipeline.py:pipelined_search_sweep(defer_sync)":
        "the 4-deep schedule is the only one",
    # The port's tracer never synchronizes and keeps aggregates only; the
    # profiler's own trace replaces the exporter.
    "utils/profiling.py:StageTimer.sync": "the tracer never synchronizes",
    "utils/profiling.py:StageTimer.report": "snapshot() returns the "
                                            "aggregates; nothing read the "
                                            "table",
    "utils/profiling.py:device_trace": "an exporter nothing read; spans "
                                       "reach any torch.profiler trace as "
                                       "lte.* ranges",
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _strings(node):
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return None


def surface(path: Path, tool: bool) -> dict:
    """The public surface of one module: ``defs`` {name: parameters or
    None}, ``flags``, ``keys`` and ``strings`` {constant: its strings}."""
    tree = ast.parse(path.read_text(), filename=str(path))
    defs, strings = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            defs[node.name] = None
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (
                        m.name == "__init__" or not m.name.startswith("_")):
                    defs[f"{node.name}.{m.name}"] = _params(m)
                elif isinstance(m, ast.AnnAssign) and isinstance(
                        m.target, ast.Name):
                    defs[f"{node.name}.{m.target.id}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    defs[t.id] = None
                    if tool and _strings(node.value) is not None:
                        strings[t.id] = _strings(node.value)
    defs = {k: v for k, v in defs.items()
            if not any(part.startswith("_") and part != "__init__"
                       for part in k.split("."))}
    flags, keys = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "add_argument":
            flags.update(a.value for a in node.args
                         if isinstance(a, ast.Constant)
                         and str(a.value).startswith("-"))
        elif tool and isinstance(node, ast.Dict):
            keys.update(k.value for k in node.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str))
        elif tool and isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            keys.add(node.slice.value)
    return {"defs": defs, "flags": flags, "keys": keys, "strings": strings}


def _string_constants(path: Path) -> set:
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _entry(item: str):
    """The JAX_ONLY entry that allows ``item`` (a parameter also when its
    function's entry lists it among several), or None."""
    if item in JAX_ONLY:
        return item
    if item.endswith(")"):
        head, name = item[:-1].split("(")
        for k in JAX_ONLY:
            if k.startswith(head + "(") and \
                    name in k[len(head) + 1:-1].split(", "):
                return k
    return None


def walk():
    """Every JAX item without a counterpart in the port, and the entries
    of RENAMED and JAX_ONLY the walk used."""
    missing, used = [], set()

    def allow(item):
        entry = _entry(item)
        used.add(entry)
        return entry is not None

    for jpath in sorted(JAX.rglob("*.py")):
        rel = jpath.relative_to(JAX).as_posix()
        ppath = PORT / MODULES.get(rel, rel)
        if not ppath.exists():
            if not allow(rel):
                missing.append(rel)
            continue
        tool = rel.startswith("tools/")
        j, p = surface(jpath, tool), surface(ppath, tool)
        for name, params in j["defs"].items():
            item = f"{rel}:{name}"
            pname = RENAMED.get(item, name)
            if item in RENAMED:
                used.add(item)
                if pname.startswith("-"):
                    assert pname in p["flags"], (item, pname)
                    continue
            if pname not in p["defs"]:
                if not allow(item):
                    missing.append(item)
                continue
            pparams = p["defs"][pname]
            for arg in params or ():
                pitem = f"{rel}:{name}({arg})"
                parg = RENAMED.get(pitem, arg)
                if pitem in RENAMED:
                    used.add(pitem)
                if parg not in (pparams or ()) and not allow(pitem):
                    missing.append(pitem)
        for flag in sorted(j["flags"] - p["flags"]):
            if not allow(f"{rel} {flag}"):
                missing.append(f"{rel} {flag}")
        for key in sorted(j["keys"] - p["keys"]):
            item = f"{rel}['{key}']"
            if item in RENAMED:
                used.add(item)
                path, value = RENAMED[item][:-2].split("['")
                if value in _string_constants(PORT / path):
                    continue
            if not allow(item):
                missing.append(item)
        for const, values in j["strings"].items():
            for v in values:
                item = f"{rel}:{const}['{v}']"
                if v not in p["strings"].get(const, ()) and not allow(item):
                    missing.append(item)
    return missing, used


def test_port_has_every_jax_item():
    missing, used = walk()
    assert not missing, f"JAX items without a port counterpart: {missing}"
    used.discard(None)
    assert set(RENAMED) | set(JAX_ONLY) == used, \
        f"entries the walk no longer needs: " \
        f"{sorted((set(RENAMED) | set(JAX_ONLY)) - used)}"
    assert all(reason.strip() for reason in JAX_ONLY.values())


_IMPORT_EACH = r"""
import importlib, json, sys
mods = json.loads(sys.argv[1])
exports = json.loads(sys.argv[2])
bad = {}
for mod in mods:
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "lte_cell_scanner_tpu_torch"]:
        del sys.modules[name]
    try:
        m = importlib.import_module(mod)
        for name in exports.get(mod, ()):
            getattr(m, name)
    except Exception as e:
        bad[mod] = repr(e)
print(json.dumps(bad))
"""


def _exports(init: Path) -> list:
    """The names a JAX package __init__ imports (its exports)."""
    tree = ast.parse(init.read_text())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_each_module_imports_first_and_exports():
    """Each port module imports first, on its own (a fresh set of the
    port's modules each time), and each subpackage gives the names its
    JAX counterpart exports, taken from the port's own modules."""
    mods = sorted(
        "lte_cell_scanner_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts).replace(
            ".__init__", "")
        for p in PORT.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    exports = {}
    for init in JAX.glob("*/__init__.py"):
        names = _exports(init)
        if names:
            exports[f"lte_cell_scanner_tpu_torch.{init.parent.name}"] = names
    assert set(exports) == {f"lte_cell_scanner_tpu_torch.{p}" for p in (
        "ops", "search", "io", "utils", "models", "tracker", "parallel")}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_EACH, json.dumps(mods),
         json.dumps(exports)], cwd=REPO, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == {}
    from lte_cell_scanner_tpu_torch.search import cell_search
    from lte_cell_scanner_tpu_torch.search.cell_search import \
        cell_search as fn

    assert cell_search is fn
