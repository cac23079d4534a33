"""Runs one cell of ``BENCHMARK.json``: finds its files by name, drives
the program through the traffic's runner, reads every metric the cell
reports through its reader, and judges ``correct`` against the cell's
limits.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import time
import types
from typing import Dict, List, Optional

import torch

from bench import checks

ROOT = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Run:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    fault: Optional[str] = None


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str, root: pathlib.Path = ROOT):
    """(workload entry, configuration, traffic, limits) of a cell, each
    found by the name ``BENCHMARK.json`` gives it."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return (w, load_json(root / entry["file"]),
            load_json(root / "bench" / "traffic" / f"{w['traffic']}.json"),
            load_json(root / "bench" / "limits" / f"{workload}.json"))


def cell_metrics(spec: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced.  A per-layer metric lists its cells under
    ``workloads``; an end-to-end metric without that key (``setup_s``)
    is every cell's."""
    if not traced:
        return [m for m in spec["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m for m in spec["per_layer"] if workload in m["workloads"]]


def runner(kind: str) -> types.ModuleType:
    """``bench/runners/<kind>.py``: the runner of a traffic file's
    ``kind``."""
    return importlib.import_module(f"bench.runners.{kind}")


def reader(name: str, root: pathlib.Path = ROOT) -> types.ModuleType:
    """``bench/metrics/<name>.py`` as a module."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_record(dev: torch.device, rec: dict) -> Dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1}
    else:
        out = {"platform": dev.type, "kind": dev.type, "count": 1}
    out["memory_peak_bytes"] = rec.get("memory_peak_bytes", 0)
    t = rec.get("trace")
    if t is not None:
        out["busy_s"] = t.busy_s
        out["window_s"] = t.window_s
    return out


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", fault: Optional[str] = None,
             spec: Optional[dict] = None, files=None,
             t_start: Optional[float] = None,
             root: pathlib.Path = ROOT) -> dict:
    """One run of a cell; returns the result line's object.  ``spec`` and
    ``files`` (as :func:`cell_files` returns them) stand in for the
    repository's, and ``fault`` plants a fault (``faults.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_json(root / "BENCHMARK.json")
    w, cfg, tr, limits = files or cell_files(spec, workload, root)
    r = Run(w, cfg, tr, limits, seed, seconds, traced,
            torch.device(device), t_start, fault)
    rec = runner(tr["kind"]).run(r)
    ctx = types.SimpleNamespace(config=cfg, traffic=tr, rec=rec,
                                workload=w)
    metrics = {}
    for m in cell_metrics(spec, w["name"], traced):
        v = reader(m["name"], root).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ok, judged, unjudged = checks.judge(rec["numbers"], limits)
    out = {"correct": ok and rec["failed"] == 0,
           "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": device_record(r.device, rec)}
    t = rec.get("trace")
    if t is not None:
        out["breakdown"] = {"device_ops": t.top_device_ops(),
                            "idle_gaps": t.idle_gaps()}
        out["trace_notes"] = t.notes()
    out["reference_s"] = rec.get("reference_s")
    out["unjudged"] = unjudged
    out["checks"] = judged
    return out
