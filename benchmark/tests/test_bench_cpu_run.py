"""Runs of the harness without a card: the entry point refuses and
prints no result; a tiny run on the CPU is correct and reports no
device metric."""

import pytest

from benchmark import run as bench_run
from benchmark.harness import result_line, run_cell
from benchmark.tests.tiny import SEED, overrides


def test_entry_point_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = bench_run.main(["--workload", "band17.sweep", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA card" in out.err


@pytest.mark.parametrize("cell", ["band17.sweep", "band17.serial",
                                  "tracker739.site1"])
def test_tiny_run_is_correct_and_reports_no_device_metric(cell):
    run = run_cell(cell, SEED, 1.0, True, device="cpu",
                   overrides=overrides(cell))
    assert run.correct, run.checks
    assert run.attempted > 0 and run.trace is None
    assert not any(k.endswith(("idle", "roofline", "per_carrier",
                               "per_capture")) for k in run.metrics)
    with pytest.raises(RuntimeError):
        result_line(run)
