"""GPipe-style pipeline forward over the shards of a
:class:`~repro_torch.distributed.moba_sp.CPGroup`, the counterpart of the
reference's ``distributed/pipeline.py``.

Stage s holds slice s of the stacked params on ``group.devices[s]``;
microbatches stream through with the classic GPipe bubble.  The
reference runs the schedule as a ``shard_map`` body that ``ppermute``\\s
each stage's output to the next; here one host process walks the same
ticks, and an activation passes to the next stage through
:meth:`CPGroup.send` (kind ``act``), the last stage's outputs to the
lead (kind ``out``).  Forward only, as the reference.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor of a tensor or a nested dict of them."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leading_dims(tree: Any) -> set:
    if isinstance(tree, dict):
        return set().union(*(_leading_dims(v) for v in tree.values()))
    return {tree.shape[0]}


def pipeline_forward(stage_fn: Callable, params_stacked: Any,
                     x: torch.Tensor, group, num_microbatches: int = 4
                     ) -> torch.Tensor:
    """x (B, ...) on the lead -> ``stage_fn`` applied S = ``group.size``
    times, stage s with slice s of every leaf of ``params_stacked`` (a
    tensor or nested dict whose leaves have leading dim S).

    Microbatch i (rows [i·B/M, (i+1)·B/M)) enters stage 0 at tick i and
    leaves stage S-1 at tick i + S - 1: S + M - 1 ticks.  A stage with no
    microbatch at a tick (the bubble) does nothing: the reference
    computes on zeros there and discards the result.  The outputs come
    back to the lead in microbatch order."""
    s_count, m = group.size, num_microbatches
    b = x.shape[0]
    if m < 1 or b % m:
        raise ValueError(f"a batch of {b} rows does not split into {m} "
                         f"microbatches")
    dims = _leading_dims(params_stacked)
    if dims != {s_count}:
        raise ValueError(f"params_stacked needs a leading dim of "
                         f"{s_count} (one slice a stage), got "
                         f"{sorted(dims)}")
    stage_params = [_map(lambda p, s=s: p[s].to(dev), params_stacked)
                    for s, dev in enumerate(group.devices)]
    mb = x.reshape(m, b // m, *x.shape[1:])
    held = {}                      # stage -> (microbatch, its input)
    outs = [None] * m
    for t in range(s_count + m - 1):
        if t < m:
            held[0] = (t, mb[t])
        nxt = {}
        for s in range(s_count):
            if s not in held:
                continue
            i, inp = held[s]
            y = stage_fn(stage_params[s], inp)
            if s + 1 < s_count:
                nxt[s + 1] = (i, group.send(y, s, s + 1, "act"))
            else:
                outs[i] = group.send(y, s, 0, "out")
        held = nxt
    return torch.cat(outs)
