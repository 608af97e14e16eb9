"""With the timed path broken underneath, a run comes out not correct:
a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced. (The cells run on one chip: there
is no exchange between chips to leave out.)"""

import dataclasses
import importlib

import pytest

from benchmark.harness import run_cell
from benchmark.tests.tiny import SEED, overrides


def _alter(cells):
    return [dataclasses.replace(c, n_id_1=(c.n_id_1 + 1) % 168)
            for c in cells]


def sweep_fault(kind):
    from lte_cell_scanner_tpu_torch.parallel import fc_sweep

    real = fc_sweep.sharded_search_sweep

    def fake(capbufs, fc_list, *args, **kwargs):
        per_cap, good = real(capbufs, fc_list, *args, **kwargs)
        if kind == "unchanged":
            return [[] for _ in fc_list], []
        half = len(fc_list) // 2
        if kind == "half":          # the half that holds 739.0 MHz
            return [[]] * half + per_cap[half:], []
        if kind == "other_half":    # the half of the second recording's site
            return per_cap[:half] + [[]] * (len(fc_list) - half), []
        return [_alter(c) for c in per_cap], []

    return fc_sweep, "sharded_search_sweep", fake


def serial_fault(kind):
    mod = importlib.import_module(
        "lte_cell_scanner_tpu_torch.search.cell_search")
    real = mod.cell_search

    def fake(*args, **kwargs):
        return [] if kind == "unchanged" else _alter(real(*args, **kwargs))

    return mod, "cell_search", fake


def tracker_fault(kind):
    from lte_cell_scanner_tpu_torch.tracker import batch_runtime

    if kind == "unchanged":
        return (batch_runtime.BatchTrackerEngine, "process_all",
                lambda self, cells: None)
    return batch_runtime, "_mib_check", lambda cell, c_est: False


CASES = [("band17.sweep", sweep_fault, "unchanged"),
         ("band17.sweep", sweep_fault, "half"),
         ("band17.sweep", sweep_fault, "other_half"),
         ("band17.sweep", sweep_fault, "altered"),
         ("band17.serial", serial_fault, "unchanged"),
         ("band17.serial", serial_fault, "altered"),
         ("tracker739.site1", tracker_fault, "unchanged"),
         ("tracker739.site1", tracker_fault, "altered")]


@pytest.mark.parametrize("cell,fault,kind", CASES,
                         ids=[f"{c}-{k}" for c, _, k in CASES])
def test_fault_is_not_correct(monkeypatch, cell, fault, kind):
    monkeypatch.setattr(*fault(kind))
    run = run_cell(cell, SEED, 1.0, False, device="cpu",
                   overrides=overrides(cell))
    assert not run.correct, run.checks
