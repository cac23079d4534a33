"""The numbers that decide ``correct``, and their judgement against a
cell's limits (``limits/<workload>.json``).  A number the cell's file
gives no limit (one that no control or fault separates from sound runs)
is reported and not judged.

Training: each checked step's loss and unclipped gradient norm, as a
share of the reference's; and by the worst leaf, the gap between the
program's and the reference's norm of the first gradient and of the
change over the checked steps, each against the larger of that leaf's
reference norm and the median leaf's.  Leaves whose reference gradient
is under a thousandth of the median leaf's move under Adam by round-off
alone and are left out of the change.

Serving: the widest gap by which a served token's fp32 logit lies below
the reference's best at its position.
"""
from __future__ import annotations

import statistics
from typing import Dict, Tuple

ZERO_GRAD = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    med = statistics.median(ref["first_grad"].values())
    moving = {k for k, v in ref["first_grad"].items()
              if v >= ZERO_GRAD * med}
    return {
        "loss_gap": max(_rel(a, b) for a, b in zip(got["loss"],
                                                   ref["loss"])),
        "grad_norm_gap": max(_rel(a, b) for a, b in
                             zip(got["grad_norm"], ref["grad_norm"])),
        "first_grad_leaf_gap": leaf_gap(got["first_grad"],
                                        ref["first_grad"]),
        "change_leaf_gap": leaf_gap(got["change"], ref["change"], moving),
    }


def serve_numbers(gaps) -> Dict[str, float]:
    return {"logit_gap": max(gaps)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict], Dict[str, float]]:
    """(every number with a limit within it, {name: {value, limit}} of
    those, {name: value} of the numbers without a limit, which are
    reported and not judged)."""
    judged = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items() if k in limits}
    ok = bool(judged) and all(c["value"] <= c["limit"]
                              for c in judged.values())
    return ok, judged, {k: v for k, v in numbers.items()
                        if k not in limits}
