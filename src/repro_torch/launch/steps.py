"""Step-function builders: the training step and the paged serving
engine's prefill and decode steps.

The reference jits these and donates the params, optimizer state and
cache arguments; the port runs them eagerly and updates params, moments
and pools in place, so the returned trees are the ones passed in.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serving.scheduler import UnsupportedFeatureError


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    backend: str = "sparse", remat: bool = True,
                    accum_in_loss: bool = False):
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, {'loss', 'lr', 'grad_norm'})`` with ``batch``
    {'tokens': (B, S+1)}.  Gradients come from torch autograd through
    :func:`repro_torch.models.transformer.lm_loss` (``remat`` checkpoints
    each layer group), then one :func:`repro_torch.optim.adamw.
    adamw_update`.

    Gradient accumulation (``tcfg.microbatch > 1``, ``accum_in_loss``) is
    the reference's and is not ported yet (ROADMAP.md §A)."""
    if tcfg.microbatch and tcfg.microbatch > 1:
        raise UnsupportedFeatureError(
            "microbatch", "gradient accumulation is not ported yet; "
                          "ROADMAP.md §A lists it after the training slice")
    if accum_in_loss:
        raise UnsupportedFeatureError(
            "accum_in_loss", "accumulation inside the loss is not ported "
                             "yet; ROADMAP.md §A lists it after the "
                             "training slice")
    lr_fn = adamw.cosine_schedule(tcfg)

    def train_step(params, opt_state, batch):
        leaves = [leaf.requires_grad_() for _, leaf in
                  adamw.tree_leaves(params)]
        loss, _ = T.lm_loss(params, batch, cfg, backend=backend,
                            remat=remat)
        grads = adamw.tree_like(params, torch.autograd.grad(loss, leaves))
        params, opt_state, om = adamw.adamw_update(params, grads, opt_state,
                                                   tcfg, lr_fn)
        out = {"loss": loss.detach()}
        out.update(om)
        return params, opt_state, out

    return train_step


def as_route_map(route_map, device=None
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """A routing profile's ``{"slot_i": (n_groups, H)}`` head budgets as
    contiguous int32 tensors (on ``device``; None keeps a tensor's own
    device).  The engine converts once, at build: a step then reads a
    budget row as a view, so it uploads, casts and launches nothing for
    it."""
    if route_map is None:
        return None
    return {k: torch.as_tensor(v, dtype=torch.int32,
                               device=device).contiguous()
            for k, v in route_map.items()}


def make_paged_prefill_step(cfg: ModelConfig, backend: str = "reference",
                            chunked: bool = False, route_map=None):
    """Ragged prefill into a paged cache: tokens (B, L) right-padded with
    per-row valid length ``q_len``; rows with q_len == 0 are padding.
    ``kv_len`` gives each row's pre-step cache length (all zeros for
    one-shot prefill; chunk offsets under chunked prefill).  ``slots``
    maps prefill rows to scheduler sequence slots (kept for the
    reference's signature; only its key-conv ring buffers read it).
    ``chunked=True`` selects the chunk-aware attention path that sees
    earlier chunks through the block table.  ``route_map`` carries an
    adaptive routing profile's per-head top_k budgets (None = static; see
    :func:`as_route_map`).  Returns (sampled next token (B,) — meaningful
    only for rows whose prompt is now fully cached, caches)."""
    rmap = as_route_map(route_map)

    @torch.no_grad()
    def prefill_step(params, tokens, caches, block_table, kv_len, q_len,
                     slots, active):
        page_state = {"block_table": block_table, "kv_len": kv_len,
                      "q_len": q_len, "slots": slots, "active": active,
                      "chunked": chunked}
        positions = (kv_len[:, None] + torch.arange(tokens.shape[1],
                                                    device=tokens.device)
                     if chunked else None)
        logits, caches = T.prefill(params, tokens, cfg, caches,
                                   backend=backend, page_state=page_state,
                                   positions=positions, route_map=rmap)
        last = torch.clamp(q_len - 1, min=0).long()          # (B,)
        lg = logits[torch.arange(tokens.shape[0],
                                 device=tokens.device), last]  # (B,V)
        return torch.argmax(lg, dim=-1).to(torch.int32), caches

    return prefill_step


def make_paged_decode_step(cfg: ModelConfig, backend: str = "reference",
                           route_map=None):
    """One continuous-batching decode step over all sequence slots:
    token (B,), per-slot pre-step lengths kv_len (B,), active mask (B,).
    ``route_map`` as in :func:`make_paged_prefill_step`.  Returns (next
    token (B,), caches)."""
    rmap = as_route_map(route_map)

    @torch.no_grad()
    def decode_step(params, token, caches, block_table, kv_len, active):
        page_state = {"block_table": block_table, "kv_len": kv_len,
                      "q_len": active.to(torch.int32), "active": active}
        logits, caches = T.decode_step(params, token[:, None], cfg,
                                       caches, backend=backend,
                                       page_state=page_state,
                                       route_map=rmap)
        return (torch.argmax(logits[:, -1], dim=-1).to(torch.int32),
                caches)

    return decode_step
