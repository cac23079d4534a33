"""The readings a latent-attention MoE training cell's correctness limits
are set from (traffic ``kind`` ``train_moe``), on the chip at the cell's
own size: ``calibrate.py``'s procedure, whose training branch reads the
``train`` kind's reference.

    python3 bench/calibrate_moe.py --workload NAME --seeds 4 \
        --controls 2 --fault-seeds 1 --out FILE

For each of ``--seeds`` seeds, the numbers ``correct`` compares for a
sound run's checked steps (no window); for ``--controls`` of them, the
control's: the reference at fp8 e4m3 in the program's place against the
fp32 reference from the same weights and rows; for ``--fault-seeds``
seeds, a run with the ``half`` fault planted (``unchanged`` reads 1 by
the leaf measure, and the bias faults ``bias_frozen`` and ``bias_sign``
read about 1 by ``router_bias_gap``: they need no run).  Prints and
writes every reading, the lower reading of each number (the largest a
sound run gave) and the upper ones (the smallest the control and the
fault gave), and what each run compared (``compared``: every leaf's
first gradient and change, the bias), with the leaves farthest from the
reference printed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_train(r, raw: bool = False):
    """The control's numbers for one seed of a ``train_moe`` cell (and
    with ``raw``, what they compare: {"program": the control's steps,
    "reference": the fp32 reference's})."""
    from bench import reference, weights
    from bench import reference_latent_moe as RM
    from bench.calibrate import _free
    from bench.runners import train_moe

    cfg, tr = r.config, r.traffic
    p0 = {k: v.to("cpu") for k, v in reference.flatten(
        RM.make_params(cfg, r.seed, r.device)).items()}
    _free()
    batches = weights.train_batches(cfg, r.seed, tr["checked_steps"],
                                    tr["rows"], tr["seq_len"], r.device)
    ref = RM.train_steps(p0, list(batches), cfg, r.device,
                         chunk=tr["ref_chunk"])
    low = RM.train_steps(p0, list(batches), cfg, r.device,
                         rnd=reference.fp8, chunk=tr["ref_chunk"])
    out = train_moe.numbers(low, ref, cfg)
    return (out, {"program": low, "reference": ref}) if raw else out


def plain(x):
    """``x`` with its tensors as lists, for JSON."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x.tolist() if hasattr(x, "tolist") else x


def worst(compared: dict, key: str, n: int = 5):
    """The ``n`` leaves of ``key`` (``first_grad`` or ``change``) farthest
    from the reference, by ``checks.leaf_gap``'s measure."""
    import statistics

    got, ref = compared["program"][key], compared["reference"][key]
    med = statistics.median(ref.values())
    gap = {k: abs(got[k] - v) / max(v, med, 1e-30) for k, v in ref.items()}
    return sorted(((round(g, 6), k) for k, g in gap.items()),
                  reverse=True)[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--controls", type=int, default=2)
    ap.add_argument("--fault-seeds", type=int, default=1)
    ap.add_argument("--first-seed", type=int, default=4_300_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness
    from bench.calibrate import _free

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    w, cfg, tr, limits = harness.cell_files(spec, args.workload)
    if tr["kind"] != "train_moe":
        raise SystemExit(f"{args.workload} is a {tr['kind']!r} cell: use "
                         f"calibrate.py")
    runner = harness.runner(tr["kind"])
    dev = torch.device("cuda")

    def run(seed, fault=None):
        r = harness.Run(w, cfg, tr, limits, seed, 0.0, False, dev,
                        time.perf_counter(), fault)
        t = time.perf_counter()
        rec = runner.run(r)
        _free()
        print(f"seed {seed} fault {fault}: {rec['numbers']} "
              f"({time.perf_counter() - t:.1f} s); first gradient's worst "
              f"leaves {worst(rec['compared'], 'first_grad')}", flush=True)
        return r, rec

    out = {"workload": args.workload, "program": [], "control": [],
           "faults": {}, "compared": []}
    seeds = [args.first_seed + i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        r, rec = run(seed)
        out["program"].append({"seed": seed, **rec["numbers"]})
        out["compared"].append({"seed": seed, "run": "program",
                                **plain(rec["compared"])})
        if i < args.controls:
            t = time.perf_counter()
            c, raw = control_train(r, raw=True)
            _free()
            print(f"seed {seed} control: {c} "
                  f"({time.perf_counter() - t:.1f} s); first gradient's "
                  f"worst leaves {worst(raw, 'first_grad')}", flush=True)
            out["control"].append({"seed": seed, **c})
            out["compared"].append({"seed": seed, "run": "control",
                                    **plain(raw)})
    out["faults"]["half"] = [{"seed": s, **run(s, "half")[1]["numbers"]}
                             for s in seeds[:args.fault_seeds]]
    summary = {}
    for k in (k for k in out["program"][0] if k != "seed"):
        summary[k] = {
            "lower": max(p[k] for p in out["program"]),
            "control": min((c[k] for c in out["control"]), default=None),
            **{f: min(x[k] for x in v) for f, v in out["faults"].items()},
            "limit": limits.get(k)}
    out["summary"] = summary
    print(json.dumps(summary, indent=1))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
