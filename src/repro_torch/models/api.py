"""Model-level public API: parameter counts and the forward function.

The counts read the leaf shapes of ``transformer.param_shapes`` (the
tree ``init_lm`` builds), so a 90 B-parameter config is counted without
allocating a tensor.  The reference's ``input_specs`` is not here: its
only caller is the XLA dry run, which the port does not have.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for _, s in tree_leaves(T.param_shapes(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE-aware: only top_k + shared experts count as active."""
    total = param_count(cfg)
    if cfg.family != "moe" or not cfg.moe.num_experts:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.expert_d_ff
    pattern, n_groups = T._block_kinds(cfg)
    n_moe_layers = sum(1 for k in pattern if k not in ("cross", "ssm")
                       ) * n_groups
    inactive = n_moe_layers * (m.num_experts - m.top_k) * per_expert
    return total - inactive


def make_forward(cfg: ModelConfig, backend: str = "sparse"):
    """``forward(params, tokens (B, S), cross_kv=None, src_embeds=None) ->
    logits (B, S, V)``.  An encoder-decoder model given ``src_embeds``
    runs its encoder first and the decoder attends onto its output;
    otherwise ``cross_kv`` (image embeddings) reaches the cross slots."""

    def forward(params, tokens, cross_kv=None, src_embeds=None):
        ck = cross_kv
        if cfg.num_encoder_layers and src_embeds is not None:
            ck = T.apply_encoder(params, src_embeds, cfg, backend=backend)
        logits, _, _ = T.lm_apply(params, tokens, cfg, backend=backend,
                                  cross_kv=ck)
        return logits

    return forward
