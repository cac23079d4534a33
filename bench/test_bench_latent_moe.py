"""The latent-attention MoE cell (``moonlight16b-train-8k``): its files
and readers are found by name as new files, and its readers give nothing
where the program has no routing counter or ranges (the program before
it); at a tiny size on the CPU, the plain reference
(``reference_latent_moe.py``) agrees with the port through the whole
run, and the fp8 control and each planted fault (the bias update's
among them) come out not correct against the cell's limits.  On the chip (``-m chip``) the control fails
at the cell's own size."""
from __future__ import annotations

import copy
import time
import types

import pytest
import torch

from bench import calibrate_moe, checks, harness
from bench import reference_latent_moe as RM
from bench.conftest import ROOT, load
from bench.runners import train_moe

CELL = "moonlight16b-train-8k"
READERS = ("mfu_moe.train", "moe_share.train", "moe_imbalance.train",
           "moba_mla_roofline.train")


def tiny_cell(dtype: str = "float32"):
    """(spec, files) of the cell with the configuration at a smoke size
    and the traffic cut to rows of 64 tokens."""
    spec = load("BENCHMARK.json")
    w = {x["name"]: x for x in spec["workloads"]}[CELL]
    tr = copy.deepcopy(load(f"bench/traffic/{w['traffic']}.json"))
    tr.update(seq_len=64, batches=5, ref_chunk=32)
    cfg = RM.smoke_config(load("bench/configs/moonlight-16b-a3b.json"),
                          dtype=dtype)
    return spec, (w, cfg, tr, load(f"bench/limits/{CELL}.json"))


def test_the_cell_and_its_readers_are_found_by_name():
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    w, cfg, tr, limits = harness.cell_files(spec, CELL)
    assert tr["kind"] == "train_moe" and harness.runner(tr["kind"]).run
    assert cfg["n_routed_experts"] == 8 and cfg["vocab_size"] == 20480
    assert set(limits) == {"grad_norm_gap", "change_leaf_gap",
                           "first_grad_matrix_gap", "router_bias_gap",
                           "expert_count_gap"}
    traced = {m["name"] for m in harness.cell_metrics(spec, CELL, True)}
    assert traced == set(READERS) | {
        "device_idle.train", "peak_mem_gib.train", "backward_share.train",
        "optimizer_share.train", "recompute_share.train"}
    assert {m["name"] for m in harness.cell_metrics(spec, CELL, False)} == \
        {"train_tokens_per_s", "setup_s"}
    # a run of a program without the counter or the ranges: nothing read
    empty = types.SimpleNamespace(config=cfg, traffic=tr, workload=w,
                                  rec={"steps": 1, "window_s": 1.0,
                                       "tokens": 1, "profiled_steps": 1})
    for name in READERS:
        assert harness.reader(name).read(empty) is None, name


def test_the_readers_arithmetic():
    cfg = load("bench/configs/moonlight-16b-a3b.json")
    mfu = harness.reader("mfu_moe.train")
    # 27 x 13.76 M of attention, 69.2 M dense, 26 x 17.4 M of router and
    # shared experts, 41.9 M of head
    n = mfu.per_token_params(cfg)
    assert n == 27 * 13_762_560 + 69_206_016 + 26 * 17_432_576 + 41_943_040
    rec = {"tokens": 32768, "window_s": 1.0,
           "routing": {"held_pairs": 32768 * 6 * 8 / 64}}
    ctx = types.SimpleNamespace(config=cfg, rec=rec)
    want = 6 * (n * 32768 + 3 * 2048 * 1408 * 24576) / 989e12 * 100
    assert abs(mfu.read(ctx) - want) < 1e-9
    imb = harness.reader("moe_imbalance.train")
    ctx.rec["routing"]["held_by_layer"] = [[1, 1, 1, 1], [4, 0, 0, 0]]
    assert imb.read(ctx) == pytest.approx((1 + 4) / 2)
    roof = harness.reader("moba_mla_roofline.train")
    least = roof.mla_moba_least_s(cfg, 4, 8192)
    assert 0.01 < least < 0.1


def test_the_reference_agrees_with_the_port_at_a_tiny_size():
    spec, files = tiny_cell()
    out = harness.run_cell(CELL, 2_300_000_023, 0.2, True, device="cpu",
                           spec=spec, files=files)
    assert out["correct"], out["checks"]
    assert max(c["value"] for c in out["checks"].values()) < 1e-5
    assert out["unjudged"]["loss_gap"] < 1e-6
    assert out["unjudged"]["first_grad_leaf_gap"] < 1e-5
    assert 1.0 <= out["metrics"]["moe_imbalance.train"]["value"] < 8.0
    assert out["metrics"]["mfu_moe.train"]["value"] > 0


@pytest.mark.parametrize("fault", train_moe.FAULTS)
def test_a_fault_is_not_correct(fault):
    spec, files = tiny_cell()
    out = harness.run_cell(CELL, 2_300_000_029, 0.0, False, device="cpu",
                           fault=fault, spec=spec, files=files)
    assert not out["correct"], out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_control_fails_at_a_tiny_size():
    _, (w, cfg, tr, limits) = tiny_cell("bfloat16")
    r = harness.Run(w, cfg, tr, limits, 2_400_000_031, 0.0, False,
                    torch.device("cpu"), time.perf_counter())
    ok, judged, _ = checks.judge(calibrate_moe.control_train(r), limits)
    assert not ok, judged


@pytest.mark.chip
def test_the_control_fails_at_the_cells_size(chip):
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    w, cfg, tr, limits = harness.cell_files(spec, CELL)
    r = harness.Run(w, cfg, tr, limits, 2_400_000_037, 0.0, False,
                    torch.device("cuda"), time.perf_counter())
    ok, judged, _ = checks.judge(calibrate_moe.control_train(r), limits)
    assert not ok, judged
