"""Decoder-only LM over attention blocks (dense | swa | moba).

Layer layout is a repeating ``cfg.layer_pattern`` of slot kinds with
``num_layers == len(pattern) * n_groups``.  Params and caches keep the
reference's stacked layout — ``blocks/slot_i`` leaves carry a leading
layer-group axis — so one set of weights feeds both packages.  The
reference scans over groups; here a Python loop indexes group ``g`` of
every leaf (a view, so cache writes land in the stacked pools).

Other families (MoE, SSM, enc-dec, VLM) and the shared-attention slot
come with later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

ATTN_KINDS = ("dense", "swa", "moba")


def _block_kinds(cfg: ModelConfig):
    pattern = cfg.layer_pattern
    if cfg.num_layers % len(pattern):
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                         f"of the layer pattern {pattern}")
    bad = [k for k in pattern if k not in ATTN_KINDS]
    if bad or cfg.family != "dense":
        raise ValueError(f"the port runs dense-family attention patterns "
                         f"{ATTN_KINDS}; got family {cfg.family!r}, "
                         f"pattern {pattern}")
    return pattern, cfg.num_layers // len(pattern)


# ------------------------------------------------------------------ params
def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of leaf shapes, the reference ``init_lm``'s tree
    (``blocks/slot_i`` leaves with the leading group axis)."""
    pattern, n_groups = _block_kinds(cfg)
    d = cfg.d_model
    tree: Dict[str, Any] = {"embed": (cfg.vocab_size, d),
                            "final_norm": (d,), "blocks": {}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, cfg.vocab_size)

    def stack(t):
        return ({k: stack(v) for k, v in t.items()} if isinstance(t, dict)
                else (n_groups,) + t)

    for i, kind in enumerate(pattern):
        tree["blocks"][f"slot_{i}"] = stack({
            "norm1": (d,), "attn": L.attention_shapes(cfg, kind),
            "norm2": (d,), "mlp": L.mlp_shapes(d, cfg.d_ff)})
    return tree


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random fp32 params on ``gen.device``, with the reference's leaves
    and scales: embed ~ N(0, 0.02²), matrices ~ N(0, 1/fan_in), norm
    scales 1.  The draws differ from ``jax.random``; tests share weights
    through ``repro_torch.convert.from_jax``."""
    pattern, n_groups = _block_kinds(cfg)
    d, dev = cfg.d_model, gen.device
    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.vocab_size, d), generator=gen,
                             device=dev) * 0.02,
        "final_norm": torch.ones((d,), device=dev),
        "blocks": {},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((d, cfg.vocab_size), generator=gen,
                                        device=dev) * d ** -0.5
    lead = (n_groups,)
    for i, kind in enumerate(pattern):
        params["blocks"][f"slot_{i}"] = {
            "norm1": torch.ones(lead + (d,), device=dev),
            "attn": L.init_attention(gen, cfg, kind, lead),
            "norm2": torch.ones(lead + (d,), device=dev),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, lead),
        }
    return params


def _group(tree, gi: int):
    """Group ``gi`` of a stacked tree: views, so writes reach the stack."""
    return {k: _group(v, gi) if isinstance(v, dict) else v[gi]
            for k, v in tree.items()}


# ------------------------------------------------------------------ blocks
def apply_block(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions=None, cache=None, backend="reference",
                page_state=None, head_top_k=None):
    """Pre-LN block.  Returns (x, cache); the reference's auxiliary loss
    belongs to MoE blocks, which the port does not have yet.
    ``head_top_k``: optional (H,) int32 per-head routing budgets for this
    layer's MoBA attention (an adaptive routing profile)."""
    h, cache = L.apply_attention(
        p["attn"], L.rms_norm(x, p["norm1"], cfg.rms_norm_eps), cfg, kind,
        positions=positions, cache=cache, backend=backend,
        page_state=page_state, head_top_k=head_top_k)
    x = x + h
    h = L.apply_mlp(p["mlp"], L.rms_norm(x, p["norm2"], cfg.rms_norm_eps))
    return x + h, cache


def lm_apply(params, tokens: torch.Tensor, cfg: ModelConfig, *,
             caches: Optional[dict] = None, backend: str = "reference",
             positions: Optional[torch.Tensor] = None,
             page_state: Optional[dict] = None, remat: bool = False,
             route_map: Optional[dict] = None):
    """tokens (B, S) -> (logits (B, S, V), aux, caches).  Paged caches are
    updated in place and returned; ``aux`` (the reference's MoE loss) is
    zero for the dense family.

    ``route_map``: optional ``{"slot_i": (n_groups, H) int32}`` per-head
    MoBA routing budgets from a routing profile; group ``g``'s layer of
    slot i reads row g.  Slots absent from the map run the static
    ``top_k``.

    ``remat=True`` checkpoints each layer group (the reference's
    ``jax.checkpoint(group_body)``): its activations are recomputed in the
    backward instead of kept, so only one group's attention is alive at
    a time."""
    pattern, n_groups = _block_kinds(cfg)
    dt = getattr(torch, cfg.dtype)
    # gather then cast: the same values as casting the whole table first
    x = params["embed"][tokens.long()].to(dt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group_body(x, gi: int):
        for i, kind in enumerate(pattern):
            name = f"slot_{i}"
            p_i = _group(params["blocks"][name], gi)
            cache_i = None if caches is None else _group(caches[name], gi)
            rt = None if route_map is None else route_map.get(name)
            x, _ = apply_block(p_i, x, cfg, kind, positions=positions,
                               cache=cache_i, backend=backend,
                               page_state=page_state,
                               head_top_k=None if rt is None else rt[gi])
        return x

    for gi in range(n_groups):
        if remat:
            x = torch.utils.checkpoint.checkpoint(group_body, x, gi,
                                                  use_reentrant=False)
        else:
            x = group_body(x, gi)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(dt)
    return x @ head, aux, caches


def lm_loss(params, batch: dict, cfg: ModelConfig,
            backend: str = "reference", remat: bool = False):
    """batch: {'tokens': (B, S+1) int, optional 'mask': (B, S)} → (mean
    next-token CE + aux, {'ce', 'aux'})."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux, _ = lm_apply(params, inp, cfg, backend=backend,
                              remat=remat)
    # memory-frugal CE, as in the reference: logsumexp of the compute-dtype
    # logits plus the target gather; no fp32 (B, S, V) copy
    lse = torch.logsumexp(logits, dim=-1)                    # (B, S)
    tgt_logit = logits.gather(-1, tgt.long()[..., None])[..., 0].float()
    ll = tgt_logit - lse.float()
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(ll)
    loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux, {"ce": loss, "aux": aux}


# -------------------------------------------------------------------- cache
def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int,
                      dtype=torch.bfloat16, device="cuda",
                      kv_dtype: str = "fp32", max_seqs: int = 0) -> dict:
    """Stacked paged caches ``{"slot_i": pool}``, each pool leaf with the
    leading layer-group axis of the params.  ``max_seqs`` sizes the
    per-slot key-conv rings of MoBA slots of key-conv models (0 skips
    them)."""
    from repro_torch.serving import paged_cache as PC

    pattern, n_groups = _block_kinds(cfg)
    return {f"slot_{i}": PC.init_page_pool(
                cfg, num_pages, page_size, with_centroids=(kind == "moba"),
                dtype=dtype, device=device, kv_dtype=kv_dtype,
                groups=n_groups, max_seqs=max_seqs)
            for i, kind in enumerate(pattern)}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, caches,
            backend="reference", page_state=None, positions=None,
            route_map=None):
    """``positions`` defaults to [0, S) (fresh prompts); chunked paged
    prefill passes per-row (B, S) offsets instead.  ``route_map`` as in
    :func:`lm_apply`."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    logits, _, caches = lm_apply(params, tokens, cfg, caches=caches,
                                 backend=backend, page_state=page_state,
                                 positions=positions, route_map=route_map)
    return logits, caches


def decode_step(params, token: torch.Tensor, cfg: ModelConfig, caches,
                backend="reference", page_state=None, route_map=None):
    """token (B, 1) against paged caches; the per-sequence position is
    the scheduler's pre-step length.  ``route_map`` as in
    :func:`lm_apply`.  Returns (logits (B,1,V), caches)."""
    pos = page_state["kv_len"][:, None]                      # (B,1) ragged
    logits, _, caches = lm_apply(params, token, cfg, caches=caches,
                                 backend=backend, positions=pos,
                                 page_state=page_state, route_map=route_map)
    return logits, caches
