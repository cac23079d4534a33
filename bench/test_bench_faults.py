"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run through ``harness.run_cell`` on the
CPU at a tiny size (the harness's look for a card is in ``run.py``,
which these skip), with the cell's own limits: a sound run is correct,
and one with each fault the cell can have planted (``faults.py``) is
not."""
from __future__ import annotations

import pytest

from bench import faults, harness
from bench.conftest import tiny_cell

CELLS = {"moba340m-train-8k": faults.TRAIN, "moba1b-train-8k": faults.TRAIN,
         "moba340m-serve-c32": faults.SERVE}
CASES = [(w, f) for w, fs in CELLS.items() for f in (None,) + fs]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_is_not_correct(workload, fault, steady_clock):
    spec, files = tiny_cell(workload)
    out = harness.run_cell(workload, 2_300_000_017, 0.2, False,
                           device="cpu", fault=fault, spec=spec,
                           files=files)
    failing = [k for k, c in out["checks"].items()
               if c["value"] > c["limit"]]
    assert out["correct"] == (fault is None), out["checks"]
    assert bool(failing) == (fault is not None)
    assert list(out)[-1] == "checks"
