"""Fixtures of the benchmark's tests (``test_bench_*.py``).

They run on the CPU at a tiny size, on one torch thread.  Tests that
need the card carry the ``chip`` marker and take the ``chip`` fixture,
which skips them where no CUDA device is present (the check is made when
the test runs, never at import).  Run those on the card with
``python3 -m pytest bench -m chip``.
"""
from __future__ import annotations

import copy
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (run on the chip); skips "
                   "elsewhere")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")


@pytest.fixture
def steady_clock(monkeypatch):
    """The serving runner's clock advanced by 4 ms at each read, so that a
    window holds the same engine steps however fast the CPU runs."""
    import time
    import types

    from bench.runners import serve

    now = [time.perf_counter()]

    def perf_counter():
        now[0] += 4e-3
        return now[0]
    monkeypatch.setattr(serve, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def tiny_config(dtype: str = "float32") -> dict:
    """moba-340m's file at a width and depth a CPU test holds."""
    cfg = load("bench/configs/moba-340m.json")
    cfg.update(name="tiny", num_layers=4, d_model=64, num_heads=4,
               num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
               max_seq_len=256, dtype=dtype)
    cfg["moba"] = dict(cfg["moba"], block_size=16, top_k=2)
    cfg["attention"] = dict(cfg["attention"], window=32)
    return cfg


def tiny_cell(workload: str, dtype: str = "float32"):
    """(spec, files) of ``workload`` at a tiny size, for
    ``harness.run_cell``: the repository's spec, traffic and limits with
    the sizes cut."""
    spec = load("BENCHMARK.json")
    w = {x["name"]: x for x in spec["workloads"]}[workload]
    tr = copy.deepcopy(load(f"bench/traffic/{w['traffic']}.json"))
    if tr["kind"] == "train":
        tr.update(seq_len=64, batches=5, ref_chunk=32)
    else:
        tr.update(prompt={"dist": "log_uniform", "min": 40, "max": 160},
                  output={"dist": "uniform", "min": 4, "max": 12},
                  pool=16, check_tokens=40, profile_after_s=0.05,
                  profile_s=0.2, ref_chunk=32)
        tr["arrivals"] = {"kind": "closed", "clients": 4}
        tr["engine"] = dict(tr["engine"], max_seqs=4, max_prefill_batch=2)
    limits = load(f"bench/limits/{workload}.json")
    return spec, (w, tiny_config(dtype), tr, limits)
