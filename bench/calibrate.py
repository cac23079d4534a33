"""The readings a cell's correctness limits are set from, on the chip at
the cell's own size.

    python3 bench/calibrate.py --workload NAME --seeds 12 --controls 3 \
        --fault-seeds 3 --seconds 10 --out FILE

For each of ``--seeds`` seeds, the numbers ``correct`` compares for a
sound run of the program (training: its checked steps, no window;
serving: a ``--seconds`` window at the cell's own load).  For
``--controls`` seeds, the same numbers of the control: the reference
in the program's place at the precision below the configuration's
(fp8 e4m3 for its bf16 compute; serving: the token it puts first at
each position of the program's served sequences).  For
``--fault-seeds`` seeds, the numbers of a run with each fault the cell
can have planted under the timed path (``faults.py``; training's
``unchanged`` reads 1 by the leaf measure and needs no run).  Prints
and writes every reading, the lower reading (the largest a sound run
gave) and the upper readings (the smallest the control and each fault
gave) of each number.  One process; the kernels build once.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def control_train(r) -> dict:
    """The control's numbers for one seed of a training cell."""
    from bench import checks, reference, weights

    cfg, tr = r.config, r.traffic
    p0 = {k: v.to("cpu") for k, v in reference.flatten(
        weights.make_params(cfg, r.seed, r.device)).items()}
    _free()
    batches = weights.train_batches(cfg, r.seed, tr["checked_steps"],
                                    tr["rows"], tr["seq_len"], r.device)
    ref = reference.train_steps(p0, list(batches), cfg, r.device,
                                chunk=tr["ref_chunk"])
    low = reference.train_steps(p0, list(batches), cfg, r.device,
                                rnd=reference.fp8, chunk=tr["ref_chunk"])
    return checks.train_numbers(low, ref)


def control_serve(r, sample) -> dict:
    """The control's numbers over a sound run's served sequences."""
    from bench import checks, reference, weights

    params = weights.make_params(r.config, r.seed, r.device)
    gaps = reference.served_gaps(params, r.config, sample, r.device,
                                 rnd=reference.fp8,
                                 chunk=r.traffic["ref_chunk"])
    return checks.serve_numbers(gaps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_100_000_000)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import faults, harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    files = harness.cell_files(spec, args.workload)
    w, cfg, tr, limits = files
    runner = harness.runner(tr["kind"])
    dev = torch.device("cuda")
    train = tr["kind"] == "train"
    seconds = 0.0 if train else args.seconds

    def run(seed, fault=None):
        r = harness.Run(w, cfg, tr, limits, seed, seconds, False, dev,
                        time.perf_counter(), fault)
        t = time.perf_counter()
        rec = runner.run(r)
        _free()
        print(f"seed {seed} fault {fault}: {rec['numbers']} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        return r, rec

    out = {"workload": args.workload, "program": [], "control": [],
           "faults": {}}
    seeds = [args.first_seed + i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        r, rec = run(seed)
        out["program"].append({"seed": seed, **rec["numbers"]})
        if i < args.controls:
            t = time.perf_counter()
            c = control_train(r) if train else control_serve(r,
                                                             rec["sample"])
            _free()
            print(f"seed {seed} control: {c} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
            out["control"].append({"seed": seed, **c})
    for fault in (faults.TRAIN if train else faults.SERVE):
        if train and fault == "unchanged":
            continue
        out["faults"][fault] = [
            {"seed": s, **run(s, fault)[1]["numbers"]}
            for s in seeds[:args.fault_seeds]]
    names = [k for k in out["program"][0] if k != "seed"]
    summary = {}
    for k in names:
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
