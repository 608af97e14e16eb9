"""On the card: one short run of a cell through the entry point prints a
correct result line with the device's keys. Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.manifest import ROOT


@pytest.mark.card
def test_short_sweep_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "band17.sweep",
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert result["metrics"]["sweep_carriers_per_s"]["value"] > 0
