"""AdamW with cosine schedule, warmup, global-norm clipping.

fp32 master weights and moments; the model casts to its compute dtype at
use sites.  The paper's recipe: β = (0.9, 0.95), wd 0.1, clip 1.0, cosine
to 10% of the peak.

Plain functions on the nested param dict, as in the reference (not
``torch.optim.AdamW``).  Leaves are visited in the reference's order
(sorted keys) and named by their ``"/"``-joined paths, so the no-decay
substring test sees the same strings.  :func:`adamw_update` updates the
params and moments in place (the reference returns new trees; in place
saves one copy of each on the card) and returns them.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32, on the params' device
    mu: dict
    nu: dict


def tree_leaves(tree: dict, prefix: str = ""
                ) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in sorted-key order, paths joined by '/'."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        val = tree[key]
        if isinstance(val, dict):
            out.extend(tree_leaves(val, path))
        else:
            out.append((path, val))
    return out


def tree_like(tree: dict, leaves) -> dict:
    """A tree of ``tree``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return build(tree)


def cosine_schedule(cfg: TrainConfig) -> Callable:
    """step (int or tensor) -> fp32 learning rate: linear warmup, then a
    cosine from the peak down to 10% of it."""
    def lr(step):
        step = torch.as_tensor(step)
        warm = cfg.learning_rate * (step + 1) / max(cfg.warmup_steps, 1)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = cfg.learning_rate * (0.1 + 0.45 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < cfg.warmup_steps, warm,
                           cos).to(torch.float32)
    return lr


def adamw_init(params: dict) -> AdamWState:
    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict)
                else torch.zeros_like(v, dtype=torch.float32)
                for k, v in tree.items()}

    device = tree_leaves(params)[0][1].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros(params), zeros(params))


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every leaf by min(1, max_norm / ||grads||); returns the
    scaled tree (new tensors) and the fp32 global norm."""
    leaves = [g.float() for _, g in tree_leaves(grads)]
    gn = torch.sqrt(sum(torch.sum(g * g) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)

    def apply(tree):
        return {k: apply(v) if isinstance(v, dict) else v * scale
                for k, v in tree.items()}

    return apply(grads), gn


_NO_DECAY = ("norm", "scale", "bias", "a_log", "dt_bias", "d_skip")


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState,
                 cfg: TrainConfig, lr_fn=None
                 ) -> Tuple[dict, AdamWState, dict]:
    """One AdamW step.  Decay is ``update + wd·p`` inside the lr product,
    except on paths containing a ``_NO_DECAY`` substring; the bias
    corrections use the incremented step."""
    lr_fn = lr_fn or cosine_schedule(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_fn(state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf
    for (path, p), (_, g), (_, m), (_, n) in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
            tree_leaves(state.nu)):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        n.mul_(b2).add_((1 - b2) * g * g)
        update = (m / c1) / (torch.sqrt(n / c2) + 1e-8)
        if cfg.weight_decay and not any(t in path for t in _NO_DECAY):
            update = update + cfg.weight_decay * p.float()
        p.copy_(p - lr * update)
    return params, AdamWState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
