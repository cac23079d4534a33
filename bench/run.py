"""Run one benchmark cell on the chip and print its result line.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cards the cell
asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; its last key, ``checks``, gives
each number ``correct`` compared beside its limit, as do the last lines
of standard error.  Exits non-zero and prints no result without the
cards, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]   # not bench/ itself
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from bench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed % (1 << 63),
                           args.seconds, bool(args.trace), spec=spec,
                           t_start=T_START, root=ROOT)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
