"""What the benchmark imports, and that it is driven by data.

Nothing the harness runs imports JAX or the JAX package (``repro``),
compared by whole top-level module names (the port, ``repro_torch``,
begins with ``repro``); the yardstick (the reference, the arithmetic,
the checks, the trace reduction, the generator and the readers) imports
nothing of the port either.  A configuration, a traffic mix, a cell's
limits and a per-layer metric added as new files, with entries in a
copy of ``BENCHMARK.json``, are found by name and run, and no file that
was there changes.
"""
from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import shutil

from bench.conftest import ROOT, tiny_cell

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "arith.py", "checks.py", "trace.py",
             "traffic.py", "weights.py", "readers.py")


def imported(path: pathlib.Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def harness_files():
    return [p for p in BENCH.rglob("*.py")
            if not p.name.startswith("test_") and p.name != "conftest.py"
            and "__pycache__" not in p.parts]


def test_nothing_the_harness_runs_imports_jax_or_the_jax_package():
    files = harness_files()
    assert any(p.name == "run.py" for p in files)
    for p in files:
        assert not set(imported(p)) & FORBIDDEN, p


def test_the_yardstick_imports_nothing_of_the_port():
    files = [BENCH / f for f in YARDSTICK] + list(
        (BENCH / "metrics").glob("*.py"))
    for p in files:
        names = set(imported(p))
        assert "repro_torch" not in names, p
        assert not any(isinstance(n, ast.ImportFrom) and n.module
                       and n.module.startswith("bench.runners")
                       for n in ast.walk(ast.parse(p.read_text()))), p


def test_forbidden_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.models\nfrom repro_torch import x\n"
                 "import jaxtyping\n")
    assert set(imported(p)) == {"repro_torch", "jaxtyping"}
    assert not set(imported(p)) & FORBIDDEN


def _digests(root: pathlib.Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in [root / "BENCHMARK.json", *(root / "bench").rglob("*")]
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    from bench import harness

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    _, (_, cfg, tr, limits) = tiny_cell("moba1b-train-8k")

    # the new files
    (root / "bench/configs/tiny-probe.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/probe-train.json").write_text(json.dumps(tr))
    (root / "bench/limits/tiny-probe-train.json").write_text(
        json.dumps(limits))
    (root / "bench/metrics/probe_steps.train.py").write_text(
        "def read(ctx):\n    return float(ctx.rec['steps'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-probe", "source": "a test",
                            "file": "bench/configs/tiny-probe.json",
                            "reduced": [], "why": "a probe"})
    spec["workloads"].append({"name": "tiny-probe-train",
                              "config": "tiny-probe",
                              "traffic": "probe-train", "chips": 1,
                              "why": "a probe"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-probe-train")
    spec["per_layer"].append({"name": "probe_steps.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "step",
                              "moves": "train_tokens_per_s",
                              "workloads": ["tiny-probe-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    traced = harness.run_cell("tiny-probe-train", 5, 0.1, True,
                              device="cpu", spec=spec, root=root)
    assert traced["correct"]
    assert traced["metrics"]["probe_steps.train"]["value"] >= 1
    assert {m["name"] for m in harness.cell_metrics(
        spec, "tiny-probe-train", False)} == {"train_tokens_per_s",
                                              "setup_s"}
    after = _digests(root)
    assert [k for k in before if before[k] != after[k]] == [
        "BENCHMARK.json"]        # only its new entries: no file edited
