"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or the
JAX package; module names are compared whole by their top-level part,
since the port's name begins with the JAX package's."""

import subprocess
import sys

from benchmark.harness import banned_modules
from benchmark.manifest import ROOT


def test_whole_name_comparison():
    mods = ["lte_cell_scanner_tpu_torch", "lte_cell_scanner_tpu_torch.ops",
            "jaxtyping", "flaxen", "numpy"]
    assert banned_modules(mods) == []
    assert banned_modules(mods + ["jax._src.core", "jaxlib", "flax.linen",
                                  "lte_cell_scanner_tpu.search"]) == [
        "flax.linen", "jax._src.core", "jaxlib", "lte_cell_scanner_tpu.search"]


def test_a_run_loads_none_of_them():
    """A tiny sweep on the CPU in a fresh process, then the check."""
    code = (
        "import json, sys\n"
        "from benchmark.harness import banned_modules, run_cell\n"
        "from benchmark.tests.tiny import SEED, overrides\n"
        "run = run_cell('band17.sweep', SEED, 0.5, False, device='cpu',\n"
        "               overrides=overrides('band17.sweep'))\n"
        "print(json.dumps([run.correct, banned_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"
