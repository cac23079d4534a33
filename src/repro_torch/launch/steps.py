"""Step-function builders for the paged serving engine.

The reference jits these and donates the cache argument; the port runs
them eagerly and the pools are updated in place, so the returned caches
are the ones passed in.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_paged_prefill_step(cfg: ModelConfig, backend: str = "reference",
                            chunked: bool = False):
    """Ragged prefill into a paged cache: tokens (B, L) right-padded with
    per-row valid length ``q_len``; rows with q_len == 0 are padding.
    ``kv_len`` gives each row's pre-step cache length (all zeros for
    one-shot prefill; chunk offsets under chunked prefill).  ``slots``
    maps prefill rows to scheduler sequence slots (kept for the
    reference's signature; only its key-conv ring buffers read it).
    ``chunked=True`` selects the chunk-aware attention path that sees
    earlier chunks through the block table.  Returns (sampled next token
    (B,) — meaningful only for rows whose prompt is now fully cached,
    caches)."""

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
                                   positions=positions)
        last = torch.clamp(q_len - 1, min=0).long()          # (B,)
        lg = logits[torch.arange(tokens.shape[0],
                                 device=tokens.device), last]  # (B,V)
        return torch.argmax(lg, dim=-1).to(torch.int32), caches

    return prefill_step


def make_paged_decode_step(cfg: ModelConfig, backend: str = "reference"):
    """One continuous-batching decode step over all sequence slots:
    token (B,), per-slot pre-step lengths kv_len (B,), active mask (B,).
    Returns (next token (B,), caches)."""

    @torch.no_grad()
    def decode_step(params, token, caches, block_table, kv_len, active):
        page_state = {"block_table": block_table, "kv_len": kv_len,
                      "q_len": active.to(torch.int32), "active": active}
        logits, caches = T.decode_step(params, token[:, None], cfg,
                                       caches, backend=backend,
                                       page_state=page_state)
        return (torch.argmax(logits[:, -1], dim=-1).to(torch.int32),
                caches)

    return decode_step
