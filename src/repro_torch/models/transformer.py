"""Decoder-only LM, encoder-decoder and VLM backbones over a repeating
pattern of block kinds.

Layer layout is a repeating ``cfg.layer_pattern`` of slot kinds with
``num_layers == len(pattern) * n_groups``:

  dense | swa | moba   attention block (+ SwiGLU MLP, or MoE for the
                       ``moe`` family)
  ssm                  Mamba-2 block
  shared_attn          zamba2-style shared-weight attention block: one
                       unstacked ``params["shared"]`` copy read in every
                       group, run as dense attention (the reference's
                       resolution, whatever ``attention.kind`` says)
  cross                VLM cross-attention block: dense attention from
                       the text onto ``cross_kv`` (image embeddings),
                       no RoPE, no cache (+ MLP, never MoE)
  decoder              encoder-decoder layer: self attention (MoBA when
                       ``attention.kind`` is, else dense; no key conv),
                       cross attention onto the encoder's output, MLP

Params and caches keep the reference's stacked layout — ``blocks/slot_i``
leaves carry a leading layer-group axis — so one set of weights feeds
both packages.  The reference scans over groups; here a Python loop
indexes group ``g`` of every leaf (a view, so cache writes land in the
stacked pools).

The encoder-decoder family adds ``params["encoder"]``: blocks stacked
over ``num_encoder_layers`` and a final norm, run by
:func:`apply_encoder` over stub frame embeddings.  Its kind is ``moba``
when the model's is and ``encoder_bidirectional_moba`` is set, else
``dense``; it passes ``causal=False``, which lifts the dense mask but not
MoBA's (ROADMAP.md §C).

A ``LatentMoEConfig`` model (``family`` ``latent_moe``: latent attention
in every layer, a leading dense layer, then held-expert MoE layers) is
not a repeating pattern: :func:`latent_lm_loss` and its helpers run it,
training only, with unstacked ``layers/layer_ii`` leaves.

Caches are paged pools (the serving engine; attention slots only) or
dense per-sequence caches (the fixed serving loop, :func:`init_caches`;
Mamba-2 state for ``ssm`` slots, a ``decoder`` slot's self-attention
cache under ``"self"``, none for ``cross`` slots).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

ATTN_KINDS = ("dense", "swa", "moba")
PAGED_KINDS = ATTN_KINDS + ("shared_attn",)     # the pageable slots
KINDS = PAGED_KINDS + ("ssm", "cross", "decoder")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _block_kinds(cfg: ModelConfig):
    pattern = cfg.layer_pattern
    if cfg.num_layers % len(pattern):
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                         f"of the layer pattern {pattern}")
    bad = [k for k in pattern if k not in KINDS]
    if bad or cfg.family not in FAMILIES:
        raise ValueError(f"the port runs families {FAMILIES} over the "
                         f"block kinds {KINDS}; got family "
                         f"{cfg.family!r}, pattern {pattern}")
    return pattern, cfg.num_layers // len(pattern)


def _encoder_kind(cfg: ModelConfig) -> str:
    return ("moba" if cfg.attention.kind == "moba"
            and cfg.encoder_bidirectional_moba else "dense")


def _self_kind(cfg: ModelConfig, kind: str) -> str:
    """The attention a slot's self attention runs: ``shared_attn`` dense;
    ``decoder`` MoBA or dense as the model's ``attention.kind``."""
    if kind == "shared_attn":
        return "dense"
    if kind == "decoder":
        return "moba" if cfg.attention.kind == "moba" else "dense"
    return kind


# ------------------------------------------------------------------ params
def _block_shapes(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """Leaf shapes of one ``kind`` block (the reference's ``init_block``):
    an ssm block holds ``norm1`` and ``mamba``; an attention block its
    attention, two norms and ``moe`` (the MoE family, but never on a
    ``cross`` block) or ``mlp``; a ``decoder`` block also ``cross``
    attention and ``norm_cross``."""
    d = cfg.d_model
    if kind == "ssm":
        return {"norm1": (d,), "mamba": M.mamba2_shapes(cfg)}
    ffn = ({"moe": MOE.moe_shapes(cfg)}
           if cfg.family == "moe" and kind != "cross"
           else {"mlp": L.mlp_shapes(d, cfg.d_ff)})
    cross = ({"cross": L.attention_shapes(cfg, "cross"), "norm_cross": (d,)}
             if kind == "decoder" else {})
    return {"norm1": (d,), "attn": L.attention_shapes(cfg, kind),
            "norm2": (d,), **cross, **ffn}


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of leaf shapes, the reference ``init_lm``'s tree
    (``blocks/slot_i`` leaves with the leading group axis; one unstacked
    ``shared`` block, a dense one, for ``shared_attn`` slots; with
    encoder layers, ``encoder`` holds ``blocks`` stacked over them and
    ``final_norm``)."""
    pattern, n_groups = _block_kinds(cfg)
    d = cfg.d_model
    tree: Dict[str, Any] = {"embed": (cfg.vocab_size, d),
                            "final_norm": (d,), "blocks": {}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, cfg.vocab_size)

    def stack(t, n):
        return ({k: stack(v, n) for k, v in t.items()}
                if isinstance(t, dict) else (n,) + t)

    for i, kind in enumerate(pattern):
        if kind == "shared_attn":
            tree["shared"] = _block_shapes(cfg, "dense")
        else:
            tree["blocks"][f"slot_{i}"] = stack(_block_shapes(cfg, kind),
                                                n_groups)
    if cfg.num_encoder_layers:
        tree["encoder"] = {
            "blocks": stack(_block_shapes(cfg, _encoder_kind(cfg)),
                            cfg.num_encoder_layers),
            "final_norm": (d,)}
    return tree


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                lead) -> dict:
    """One ``kind`` block's params, each leaf drawn whole with the
    ``lead`` axes (never stacked from per-group copies)."""
    d, dev = cfg.d_model, gen.device
    p: Dict[str, Any] = {"norm1": torch.ones(lead + (d,), device=dev)}
    if kind == "ssm":
        p["mamba"] = M.init_mamba2(gen, cfg, lead)
        return p
    p["attn"] = L.init_attention(gen, cfg, kind, lead)
    p["norm2"] = torch.ones(lead + (d,), device=dev)
    if kind == "decoder":
        p["cross"] = L.init_attention(gen, cfg, "cross", lead)
        p["norm_cross"] = torch.ones(lead + (d,), device=dev)
    if cfg.family == "moe" and kind != "cross":
        p["moe"] = MOE.init_moe(gen, cfg, lead)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, lead)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random fp32 params on ``gen.device``, with the reference's leaves
    and scales: embed ~ N(0, 0.02²), matrices ~ N(0, 1/fan_in), norm
    scales 1 (Mamba-2's own leaves as ``mamba2.init_mamba2``).  The
    draws differ from ``jax.random``; tests share weights through
    ``repro_torch.convert.from_jax``."""
    pattern, n_groups = _block_kinds(cfg)
    d, dev = cfg.d_model, gen.device
    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.vocab_size, d), generator=gen,
                             device=dev).mul_(0.02),
        "final_norm": torch.ones((d,), device=dev),
        "blocks": {},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((d, cfg.vocab_size), generator=gen,
                                        device=dev).mul_(d ** -0.5)
    for i, kind in enumerate(pattern):
        if kind == "shared_attn":
            if "shared" not in params:
                params["shared"] = _init_block(gen, cfg, "dense", ())
        else:
            params["blocks"][f"slot_{i}"] = _init_block(gen, cfg, kind,
                                                        (n_groups,))
    if cfg.num_encoder_layers:
        params["encoder"] = {
            "blocks": _init_block(gen, cfg, _encoder_kind(cfg),
                                  (cfg.num_encoder_layers,)),
            "final_norm": torch.ones((d,), device=dev)}
    return params


def _group(tree, gi: int):
    """Group ``gi`` of a stacked tree: views, so writes reach the stack
    (a list of tensors, a context-parallel cache's segments, gives the
    list of their views).  Host values (a dense cache's ``len``) are
    shared by every group."""
    return {k: _group(v, gi) if isinstance(v, dict)
            else v[gi] if isinstance(v, torch.Tensor)
            else [x[gi] for x in v] if isinstance(v, list) else v
            for k, v in tree.items()}


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _refill(tree: dict, it) -> dict:
    return {k: _refill(v, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}


def _group_weights(stacked: dict, gi: int) -> dict:
    """:func:`_group` of a slot's stacked weights, in a ``model.weights``
    region under the profiler: its backward assembles the group's weight
    gradients into the stacks' (one zero-filled stack a group)."""
    if not tracing.enabled():
        return _group(stacked, gi)
    with tracing.region("model.weights") as r:
        r.input(*_leaves(stacked))
        view = _group(stacked, gi)
        marked = r.output(*_leaves(view))
        return _refill(view, iter(marked if isinstance(marked, tuple)
                                  else (marked,)))


# ------------------------------------------------------------------ blocks
def apply_block(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions=None, cache=None, backend="reference",
                cross_kv=None, causal: bool = True, page_state=None,
                head_top_k=None):
    """Pre-LN block.  Returns (x, aux, cache): ``aux`` is an MoE block's
    load-balance loss (a 0-d fp32 tensor), None for any other block.
    ``shared_attn`` runs dense attention.  A ``cross`` block attends onto
    ``cross_kv`` and keeps no cache; a ``decoder`` block runs its self
    attention on the ``"self"`` sub-cache, then cross attention onto
    ``cross_kv`` after ``norm_cross``.  ``causal=False`` lifts dense
    attention's causal mask (the encoder).  ``head_top_k``: optional (H,)
    int32 per-head routing budgets for this layer's MoBA attention (an
    adaptive routing profile)."""
    if kind == "ssm":
        h, cache = M.apply_mamba2(p["mamba"], L.rms_norm(
            x, p["norm1"], cfg.rms_norm_eps), cfg, cache)
        return x + h, None, cache
    if kind == "cross":
        y = L.rms_norm(x, p["norm1"], cfg.rms_norm_eps)
        h, cache = L.apply_attention(p["attn"], y, cfg, "cross",
                                     positions=positions, backend=backend,
                                     cross_kv=cross_kv)
    else:
        self_kind = _self_kind(cfg, kind)
        self_cache = (cache["self"] if kind == "decoder"
                      and cache is not None else cache)
        with tracing.region(f"model.attn.{self_kind}") as r:
            y = L.rms_norm(r.input(x), p["norm1"], cfg.rms_norm_eps)
            h, cache = L.apply_attention(
                p["attn"], y, cfg, self_kind, positions=positions,
                cache=self_cache, backend=backend, causal=causal,
                page_state=page_state, head_top_k=head_top_k)
            h = r.output(h)
    x = x + h
    if kind == "decoder":
        h, _ = L.apply_attention(
            p["cross"], L.rms_norm(x, p["norm_cross"], cfg.rms_norm_eps),
            cfg, "cross", positions=positions, backend=backend,
            cross_kv=cross_kv)
        x = x + h
        cache = None if cache is None else {"self": cache}
    aux = None
    with tracing.region("model.mlp") as r:
        y = L.rms_norm(r.input(x), p["norm2"], cfg.rms_norm_eps)
        if "moe" in p:
            h, aux = r.output(*MOE.apply_moe(p["moe"], y, cfg))
        else:
            h = r.output(L.apply_mlp(p["mlp"], y))
    return x + h, aux, cache


def apply_encoder(params, src_embeds: torch.Tensor, cfg: ModelConfig,
                  backend: str = "reference") -> torch.Tensor:
    """The encoder over stub frontend embeddings (B, T, d_model): cast to
    ``cfg.dtype``, ``num_encoder_layers`` blocks with ``causal=False``
    and no cache, then the encoder's final norm.  Its MoBA kind stays
    causal (``MoBAConfig.causal``), as in the reference's code."""
    kind = _encoder_kind(cfg)
    x = src_embeds.to(getattr(torch, cfg.dtype))
    for li in range(cfg.num_encoder_layers):
        x, _, _ = apply_block(_group(params["encoder"]["blocks"], li), x,
                              cfg, kind, causal=False, backend=backend)
    return L.rms_norm(x, params["encoder"]["final_norm"], cfg.rms_norm_eps)


def _self_cache(cache: dict) -> dict:
    """The dict holding a slot cache's ``len``: a ``decoder`` slot's
    ``"self"`` sub-cache, else the cache itself."""
    return cache.get("self", cache)


def lm_apply(params, tokens: torch.Tensor, cfg: ModelConfig, *,
             caches: Optional[dict] = None, backend: str = "reference",
             cross_kv: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None,
             page_state: Optional[dict] = None, remat: bool = False,
             route_map: Optional[dict] = None):
    """tokens (B, S) -> (logits (B, S, V), aux, caches).  Caches are
    updated in place and returned (a dense cache's host-int ``len``
    advanced by S); ``aux`` is the MoE blocks' load-balance loss summed
    over layers (zero without MoE blocks).  ``cross_kv`` (B, M, d_model),
    the image embeddings or the encoder's output, reaches the ``cross``
    and ``decoder`` slots only.

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

    lens = {}

    def group_body(x, aux, gi: int):
        for i, kind in enumerate(pattern):
            name = f"slot_{i}"
            p_i = (params["shared"] if kind == "shared_attn"
                   else _group_weights(params["blocks"][name], gi))
            cache_i = (None if caches is None or name not in caches
                       else _group(caches[name], gi))
            rt = None if route_map is None else route_map.get(name)
            x, a, c = apply_block(
                p_i, x, cfg, kind, positions=positions, cache=cache_i,
                backend=backend, page_state=page_state,
                head_top_k=None if rt is None else rt[gi],
                cross_kv=cross_kv if kind in ("cross", "decoder") else None)
            if a is not None:
                aux = aux + a
            if c is not None and "len" in _self_cache(c):
                lens[name] = _self_cache(c)["len"]
        return x, aux

    for gi in range(n_groups):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                group_body, x, aux, gi, use_reentrant=False)
        else:
            x, aux = group_body(x, aux, gi)
    for name, n in lens.items():           # dense caches: every group
        _self_cache(caches[name])["len"] = n   # wrote the same positions
    with tracing.region("model.head") as r:
        x = L.rms_norm(r.input(x), params["final_norm"], cfg.rms_norm_eps)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"]).to(dt)
        logits = r.output(x @ head)
    return logits, aux, caches


def lm_loss(params, batch: dict, cfg: ModelConfig,
            backend: str = "reference", remat: bool = False):
    """batch: {'tokens': (B, S+1) int, optional 'mask': (B, S),
    'cross_kv': (B, M, d_model), 'src_embeds': (B, T, d_model)} → (mean
    next-token CE + aux, {'ce', 'aux'}).  With encoder layers and
    ``src_embeds``, the encoder's output replaces ``cross_kv``."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    cross_kv = batch.get("cross_kv")
    if cfg.num_encoder_layers and "src_embeds" in batch:
        cross_kv = apply_encoder(params, batch["src_embeds"], cfg,
                                 backend=backend)
    logits, aux, _ = lm_apply(params, inp, cfg, backend=backend,
                              cross_kv=cross_kv, remat=remat)
    # memory-frugal CE, as in the reference: logsumexp of the compute-dtype
    # logits plus the target gather; no fp32 (B, S, V) copy
    with tracing.region("model.head") as r:
        logits = r.input(logits)
        lse = torch.logsumexp(logits, dim=-1)                # (B, S)
        tgt_logit = logits.gather(-1, tgt.long()[..., None])[..., 0].float()
        ll = tgt_logit - lse.float()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(ll)
        loss = r.output(-(ll * mask).sum() / torch.clamp(mask.sum(),
                                                         min=1.0))
    return loss + aux, {"ce": loss, "aux": aux}


# -------------------------------------------------------------------- cache
def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda", segments=None) -> dict:
    """Stacked dense per-sequence caches ``{"slot_i": cache}``, each
    tensor leaf with the leading layer-group axis of the params:
    ``layers.init_cache`` for attention slots (``shared_attn`` as
    dense; a ``decoder`` slot's as ``attention.kind``, under ``"self"``),
    ``mamba2.init_mamba2_cache`` for ``ssm`` slots, nothing for ``cross``
    slots (their K/V are recomputed from ``cross_kv``); ``len`` is one
    host int per slot.  ``segments`` (devices) holds the MoBA slots as
    context-parallel sequence segments (``layers.init_cache``)."""
    pattern, n_groups = _block_kinds(cfg)

    def one(kind):
        if kind == "ssm":
            return M.init_mamba2_cache(cfg, batch, dtype=dtype,
                                       device=device, groups=n_groups)
        c = L.init_cache(cfg, _self_kind(cfg, kind), batch, max_len,
                         dtype=dtype, device=device, groups=n_groups,
                         segments=segments)
        return {"self": c} if kind == "decoder" else c

    return {f"slot_{i}": one(kind) for i, kind in enumerate(pattern)
            if kind != "cross"}


def _cache_len(caches) -> int:
    """A dense cache tree's length: every slot holds the same count."""
    return _self_cache(next(iter(caches.values())))["len"]


def init_paged_caches(cfg: ModelConfig, num_pages: int, page_size: int,
                      dtype=torch.bfloat16, device="cuda",
                      kv_dtype: str = "fp32", max_seqs: int = 0,
                      prefix_tails: bool = False) -> dict:
    """Stacked paged caches ``{"slot_i": pool}``, each pool leaf with the
    leading layer-group axis of the params.  ``max_seqs`` sizes the
    per-slot key-conv rings of MoBA slots of key-conv models (0 skips
    them); ``prefix_tails`` adds their per-page raw-key tails, which the
    prefix cache loads rings from.  Only attention slots are pageable
    (``shared_attn`` included); an ``ssm`` slot raises."""
    from repro_torch.serving import paged_cache as PC

    pattern, n_groups = _block_kinds(cfg)
    for kind in pattern:
        if kind not in PAGED_KINDS:
            raise ValueError(
                f"paged caches support attention-only layer patterns; "
                f"got {kind!r} in {pattern}")
    return {f"slot_{i}": PC.init_page_pool(
                cfg, num_pages, page_size, with_centroids=(kind == "moba"),
                dtype=dtype, device=device, kv_dtype=kv_dtype,
                groups=n_groups, max_seqs=max_seqs,
                prefix_tails=prefix_tails)
            for i, kind in enumerate(pattern)}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, caches,
            backend="reference", cross_kv=None, page_state=None,
            positions=None, route_map=None):
    """Prefill into paged pools or dense caches.  ``positions`` defaults
    to [0, S) (fresh prompts; a dense cache starts empty, as in the
    reference); chunked paged prefill passes per-row (B, S) offsets
    instead.  ``cross_kv`` and ``route_map`` as in :func:`lm_apply`."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    logits, _, caches = lm_apply(params, tokens, cfg, caches=caches,
                                 backend=backend, cross_kv=cross_kv,
                                 page_state=page_state, positions=positions,
                                 route_map=route_map)
    return logits, caches


def decode_step(params, token: torch.Tensor, cfg: ModelConfig, caches,
                backend="reference", cross_kv=None, page_state=None,
                route_map=None):
    """token (B, 1) against caches.  With paged caches the per-sequence
    position is the scheduler's pre-step length; with dense caches it is
    the shared cache length.  ``cross_kv`` and ``route_map`` as in
    :func:`lm_apply`.  Returns (logits (B,1,V), caches)."""
    if page_state is not None:
        pos = page_state["kv_len"][:, None]                  # (B,1) ragged
    else:
        pos = torch.arange(1, device=token.device) + _cache_len(caches)
    logits, _, caches = lm_apply(params, token, cfg, caches=caches,
                                 backend=backend, cross_kv=cross_kv,
                                 positions=pos, page_state=page_state,
                                 route_map=route_map)
    return logits, caches


# ------------------------------------------------- latent attention + MoE
def latent_param_shapes(cfg) -> Dict[str, Any]:
    """Leaf shapes of a ``LatentMoEConfig`` model: the embedding, head and
    final norm, and ``layers/layer_ii`` blocks (not stacked): latent
    attention (``layers.mla_shapes``), two norms, and a SwiGLU ``mlp``
    for the first ``first_k_dense`` layers, a held-expert ``moe``
    (``moe.held_moe_shapes``) after them."""
    d = cfg.d_model
    tree: Dict[str, Any] = {"embed": (cfg.vocab_size, d),
                            "final_norm": (d,),
                            "lm_head": (d, cfg.vocab_size), "layers": {}}
    for i in range(cfg.num_layers):
        ffn = ({"mlp": L.mlp_shapes(d, cfg.d_ff)} if i < cfg.first_k_dense
               else {"moe": MOE.held_moe_shapes(cfg)})
        tree["layers"][f"layer_{i:02d}"] = {
            "norm1": (d,), "attn": L.mla_shapes(cfg), "norm2": (d,), **ffn}
    return tree


def init_latent_lm(gen: torch.Generator, cfg) -> dict:
    """Random fp32 params of :func:`latent_param_shapes` on
    ``gen.device``: embed ~ N(0, 0.02²), matrices ~ N(0, 1/fan_in) (an
    expert stack's fan-in is its middle dim), norm scales 1."""
    dev = gen.device

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif len(v) == 1:
                out[k] = torch.ones(v, device=dev)
            else:
                out[k] = torch.randn(v, generator=gen, device=dev).mul_(
                    v[-2] ** -0.5)
        return out

    params = walk(latent_param_shapes(cfg))
    params["embed"].normal_(0.0, 0.02, generator=gen)
    return params


def init_router_state(cfg, device) -> dict:
    """The routing state a ``LatentMoEConfig`` model trains with, which
    is no parameter: ``router_bias`` and the step's ``expert_counts``,
    each (MoE layers, every expert) fp32 zeros, and ``held_over``, set
    when a layer call's held pairs outgrew their bounded buffer (0-d
    bool)."""
    shape = (cfg.num_layers - cfg.first_k_dense, cfg.moe.num_experts)
    return {"router_bias": torch.zeros(shape, device=device),
            "expert_counts": torch.zeros(shape, device=device),
            "held_over": torch.zeros((), dtype=torch.bool, device=device)}


def latent_block(p: dict, x: torch.Tensor, cfg, bias, *, positions=None,
                 backend: str = "flash", bound: int = 0, over=None):
    """One pre-norm block: latent attention (a ``model.attn.<kind>``
    region), then the SwiGLU MLP or the held-expert MoE (``model.mlp``;
    ``bound`` and ``over`` as ``moe.apply_held_moe``'s).  Returns (x,
    balance loss or None, per-expert counts or None)."""
    with tracing.region(f"model.attn.{cfg.attention.kind}") as r:
        y = L.rms_norm(r.input(x), p["norm1"], cfg.rms_norm_eps)
        h = r.output(L.apply_mla(p["attn"], y, cfg, positions=positions,
                                 backend=backend))
    x = x + h
    aux = counts = None
    with tracing.region("model.mlp") as r:
        y = L.rms_norm(r.input(x), p["norm2"], cfg.rms_norm_eps)
        if bias is None:
            h = r.output(L.apply_mlp(p["mlp"], y))
        else:
            h, aux, counts = MOE.apply_held_moe(p["moe"], y, cfg, bias,
                                                bound, over)
            h, aux = r.output(h, aux)
    return x + h, aux, counts


def latent_lm_apply(params, tokens: torch.Tensor, cfg, *,
                    backend: str = "flash", remat: bool = False,
                    state: Optional[dict] = None, bounded: bool = False):
    """tokens (B, S) -> (logits (B, S, V), the MoE layers' balance loss
    summed).  ``state`` (:func:`init_router_state`) gives the routing
    bias and gathers the pairs each expert got into ``expert_counts``
    (zero bias and no count without it); ``remat`` checkpoints each
    layer, and a layer's counts are taken from its first forward only.
    ``bounded`` (with ``state``) puts the held pairs through buffers of
    ``moe.held_bound`` rows and sets ``held_over`` when they outgrow one,
    in the forward or its recompute; else through every pair's row."""
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens.long()].to(dt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = (state["router_bias"] if state is not None else
            torch.zeros((cfg.num_layers - cfg.first_k_dense,
                         cfg.moe.num_experts), device=x.device))
    over = state["held_over"] if bounded else None
    bound = MOE.held_bound(tokens.numel(), cfg) if bounded else 0
    for i in range(cfg.num_layers):
        p = params["layers"][f"layer_{i:02d}"]
        j = i - cfg.first_k_dense
        b = None if j < 0 else bias[j]
        if remat:
            x, a, c = torch.utils.checkpoint.checkpoint(
                latent_block, p, x, cfg, b, backend=backend, bound=bound,
                over=over, use_reentrant=False)
        else:
            x, a, c = latent_block(p, x, cfg, b, backend=backend,
                                   bound=bound, over=over)
        if a is not None:
            aux = aux + a
            if state is not None:
                state["expert_counts"][j].add_(c)
    with tracing.region("model.head") as r:
        x = L.rms_norm(r.input(x), params["final_norm"], cfg.rms_norm_eps)
        logits = r.output(x @ params["lm_head"].to(dt))
    return logits, aux


def latent_lm_loss(params, batch: dict, cfg, backend: str = "flash",
                   remat: bool = False, state: Optional[dict] = None,
                   bounded: bool = False):
    """:func:`lm_loss` of a ``LatentMoEConfig`` model: the mean next-token
    cross entropy plus the MoE layers' balance losses."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux = latent_lm_apply(params, inp, cfg, backend=backend,
                                  remat=remat, state=state, bounded=bounded)
    with tracing.region("model.head") as r:
        logits = r.input(logits)
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = logits.gather(-1, tgt.long()[..., None])[..., 0].float()
        ll = tgt_logit - lse.float()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(ll)
        loss = r.output(-(ll * mask).sum() / torch.clamp(mask.sum(),
                                                         min=1.0))
    return loss + aux, {"ce": loss, "aux": aux}


def train_functions(cfg, state: Optional[dict] = None):
    """(loss, retake, after_step) of a training step, chosen once when
    the step is built: :func:`lm_loss` and no hooks for every model but a
    ``LatentMoEConfig`` one, which takes :func:`latent_lm_loss` over
    ``state`` (:func:`init_router_state`), its held pairs in bounded
    buffers.  ``retake()``, before the optimizer, reads ``held_over``
    back (the step's one read of the device) and, when a layer call's
    held pairs outgrew their buffer, clears the step's counts and returns
    True: the step then takes its gradients again, over every pair.  ``after_step(out)``, after the optimizer, moves the routing bias
    by the step's counts, hands them on as ``expert_counts`` (and
    ``retaken``) and zeroes them."""
    if cfg.family != "latent_moe":
        return lm_loss, None, None
    if state is None:
        raise ValueError(f"{cfg.name} trains with a routing state "
                         f"(transformer.init_router_state)")
    rate = cfg.router.bias_rate
    bounded = [True]

    def loss(params, batch, cfg, backend, remat):
        return latent_lm_loss(params, batch, cfg, backend=backend,
                              remat=remat, state=state, bounded=bounded[0])

    @torch.no_grad()
    def retake() -> bool:
        if not bool(state["held_over"]):
            return False
        state["held_over"].zero_()
        state["expert_counts"].zero_()
        bounded[0] = False
        return True

    @torch.no_grad()
    def after_step(out: dict) -> None:
        counts = state["expert_counts"]
        MOE.update_router_bias(state["router_bias"], counts, rate)
        out["expert_counts"] = counts.clone()
        out["retaken"] = not bounded[0]
        bounded[0] = True
        counts.zero_()

    return loss, retake, after_step
