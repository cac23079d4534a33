"""Model-level public API: parameter counts, the forward function and
a cell's inputs as meta tensors.

The counts read the leaf shapes of ``transformer.param_shapes`` (the
tree ``init_lm`` builds), so a 90 B-parameter config is counted without
allocating a tensor.  :func:`input_specs` gives the dry run
(``launch/dryrun.py``) every input of an assigned shape on the ``meta``
device: shapes and dtypes, no storage.  Modality frontends are stubs:
audio archs get frame embeddings, VLMs image embeddings.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ASSIGNED_SHAPES, ModelConfig
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


def input_specs(cfg: ModelConfig, shape, dtype=torch.bfloat16,
                device="meta") -> Dict[str, Any]:
    """Every model input of one cell on ``device`` (meta: no storage).
    ``shape`` is an ``ASSIGNED_SHAPES`` name or a ``(seq_len,
    global_batch, kind)`` triple.

    kind 'train'   → {'tokens': (B, S+1)} (+ stub modality inputs)
    kind 'prefill' → {'tokens': (B, S)} (+ stubs)
    kind 'decode'  → {'token': (B, 1), 'caches': dense caches of S} (+
    stubs)"""
    s, b, kind = shape_info(shape)
    specs: Dict[str, Any] = {}
    if kind == "train":
        specs["tokens"] = torch.zeros((b, s + 1), dtype=torch.int32,
                                      device=device)
    elif kind == "prefill":
        specs["tokens"] = torch.zeros((b, s), dtype=torch.int32,
                                      device=device)
    else:
        specs["token"] = torch.zeros((b, 1), dtype=torch.int32,
                                     device=device)
        specs["caches"] = T.init_caches(cfg, b, s, dtype=dtype,
                                        device=device)
    if cfg.family == "vlm":
        specs["cross_kv"] = torch.zeros((b, cfg.num_image_tokens,
                                         cfg.d_model), dtype=dtype,
                                        device=device)
    if cfg.family == "encdec":
        specs["src_embeds"] = torch.zeros((b, cfg.num_audio_frames,
                                           cfg.d_model), dtype=dtype,
                                          device=device)
    return specs


def shape_info(shape):
    """``(seq_len, global_batch, kind)`` of an ``ASSIGNED_SHAPES`` name or
    of such a triple."""
    if isinstance(shape, str):
        info = ASSIGNED_SHAPES[shape]
        return info["seq_len"], info["global_batch"], info["kind"]
    s, b, kind = shape
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown kind {kind!r}")
    return int(s), int(b), kind


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
