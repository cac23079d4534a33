"""Gradient compression for the data-parallel reduce: int8 quantisation
with error feedback (Karimireddy et al. 2019 style), the counterpart of
the reference's ``optim/compression.py``.

Each shard adds its carried residual to its gradient, quantises the sum
to int8 under one scale that every shard agrees on, and keeps what the
quantisation lost as its next residual, so the error does not
accumulate over steps.  The arithmetic is the reference's, in its order,
so the results are bit-equal to it.

The reference's ``compressed_psum`` is a ``shard_map`` body that psums
the int8 values widened to int32: 4 bytes an element, the payload of an
fp32 reduce.  Here one host process drives the shards of a
:class:`~repro_torch.distributed.moba_sp.CPGroup`, and what crosses is
counted by :meth:`CPGroup.send`: every shard's amax scalar to every
other (kind ``amax``), each shard's int8 payload to the lead (kind
``payload``, 1 byte an element), where it is summed in int32, and the
mean back to each shard in the gradient's dtype (kind ``result``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_like


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g + carried fp32 residual -> (int8 q, fp32 scale, new residual)."""
    gf = g.float() + residual
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residuals(params: dict) -> dict:
    """fp32 zeros of every leaf's shape, on its device."""
    return tree_like(params, [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                              for _, p in tree_leaves(params)])


def compressed_psum(trees: Sequence[dict], residuals: Sequence[dict],
                    group) -> Tuple[List[dict], List[dict]]:
    """The mean of the shards' gradient trees through int8 with error
    feedback.  ``trees[s]`` and ``residuals[s]`` are shard s's gradients
    and fp32 residuals, on ``group.devices[s]``; returns (the mean tree
    for each shard, each shard's new residuals), each on its shard's
    device and every shard's mean bit-equal.

    Per leaf, as the reference: ``gf = g + r``; ``s = max(max over shards
    of amax|gf| / 127, 1e-12)``; ``q = clip(round_half_even(gf / s),
    -127, 127)``; ``r' = gf - q·s``; the mean is ``(Σ_shards q) · s / n``
    in fp32, cast to g's dtype."""
    n = group.size
    if len(trees) != n or len(residuals) != n:
        raise ValueError(f"compressed_psum over {n} shards takes one tree "
                         f"and one residual tree a shard, got "
                         f"{len(trees)} and {len(residuals)}")
    flat = [[g for _, g in tree_leaves(t)] for t in trees]
    res = [[r for _, r in tree_leaves(t)] for t in residuals]
    means = [[] for _ in range(n)]
    new_res = [[] for _ in range(n)]
    for i in range(len(flat[0])):
        gf = [flat[s][i].float() + res[s][i] for s in range(n)]
        amax = [x.abs().max() for x in gf]
        q, scales = [], []
        for s in range(n):
            # the all-gather of the amax scalars: every shard computes
            # the same scale from the same values
            peak = torch.stack([group.send(amax[t], t, s, "amax")
                                for t in range(n)]).max()
            scale = torch.clamp(peak / 127.0, min=1e-12)
            q_s = torch.clamp(torch.round(gf[s] / scale), -127,
                              127).to(torch.int8)
            new_res[s].append(gf[s] - q_s.float() * scale)
            q.append(q_s)
            scales.append(scale)
        tot = q[0].to(torch.int32)
        for s in range(1, n):
            tot += group.send(q[s], s, 0, "payload")
        mean = (tot.float() * scales[0] / n).to(flat[0][i].dtype)
        for s in range(n):
            means[s].append(group.send(mean, 0, s, "result"))
    return ([tree_like(trees[s], means[s]) for s in range(n)],
            [tree_like(trees[s], new_res[s]) for s in range(n)])
