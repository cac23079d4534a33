"""The control comes out not correct: the reference put in the program's
place at the precision below the configuration's (fp8 e4m3 for its bf16
compute) fails one of the cell's numbers against the cell's limits.

On the CPU at a tiny size in the configuration's precision, one seed;
on the chip at the cell's own size (``-m chip``), three seeds each."""
from __future__ import annotations

import time

import pytest
import torch

from bench import calibrate, checks, harness
from bench.conftest import ROOT, tiny_cell

CELLS = ["moba340m-train-8k", "moba1b-train-8k", "moba340m-serve-c32"]
SEEDS = (2_400_000_011, 2_400_000_012, 2_400_000_013)


def control_numbers(files, seed: int, device, seconds: float):
    """The control's numbers on ``seed``: training from the same weights
    and rows; serving over a sound run's served sequences."""
    w, cfg, tr, limits = files
    r = harness.Run(w, cfg, tr, limits, seed, 0.0, False,
                    torch.device(device), time.perf_counter())
    if tr["kind"] == "train":
        return calibrate.control_train(r)
    r.seconds = seconds
    rec = harness.runner("serve").run(r)
    return calibrate.control_serve(r, rec["sample"])


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_a_tiny_size(workload, steady_clock):
    _, files = tiny_cell(workload, dtype="bfloat16")
    ok, judged, _ = checks.judge(
        control_numbers(files, SEEDS[0], "cpu", 0.2), files[3])
    assert not ok, judged


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(chip, workload):
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    files = harness.cell_files(spec, workload)
    for seed in SEEDS:
        ok, judged, _ = checks.judge(
            control_numbers(files, seed, "cuda", 10.0), files[3])
        assert not ok, judged
