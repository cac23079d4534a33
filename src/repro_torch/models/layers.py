"""Model primitives: RMSNorm, RoPE, SwiGLU MLP, GQA attention layers.

Functional style as in the reference: params are plain dicts of tensors
(the JAX package's layout, so one set of weights feeds both), and
``apply(params, x) -> y``.  Compute in ``cfg.dtype`` (bf16 by default),
params in fp32; all attention math fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import attention_dispatch
from repro_torch.core.key_conv import apply_key_conv, init_key_conv


def wcast(w: torch.Tensor, dt) -> torch.Tensor:
    """Cast an fp32 weight to the compute dtype before its matmul (the
    reference's sharding hint around the cast has no counterpart on one
    card)."""
    return w.to(dt)


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions, theta: float = 10000.0
               ) -> torch.Tensor:
    """x: (B, H, N, d); positions: (N,) shared or (B, N) per-sequence
    (ragged serving batches where each row sits at a different offset)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    positions = torch.as_tensor(positions, device=x.device)
    ang = positions[..., None].float() * freqs               # (..., N, d/2)
    ang = ang[None, None] if positions.ndim == 1 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _init_leaves(gen: torch.Generator, shapes: dict,
                 lead: Tuple[int, ...]) -> dict:
    """Matrices ~ N(0, 1/fan_in), norm scales 1; ``lead`` prepends the
    layer-group axis."""
    p = {}
    for name, shape in shapes.items():
        if name.endswith("norm_scale"):
            p[name] = torch.ones(lead + shape, device=gen.device)
        else:
            p[name] = torch.randn(lead + shape, generator=gen,
                                  device=gen.device) * shape[0] ** -0.5
    return p


# --------------------------------------------------------------------- mlp
def mlp_shapes(d_model: int, d_ff: int) -> dict:
    return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
            "w_down": (d_ff, d_model)}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             lead: Tuple[int, ...] = ()) -> dict:
    return _init_leaves(gen, mlp_shapes(d_model, d_ff), lead)


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = (torch.nn.functional.silu(x @ wcast(p["w_gate"], dt))
         * (x @ wcast(p["w_up"], dt)))
    return h @ wcast(p["w_down"], dt)


# --------------------------------------------------------------- attention
def _key_conv_width(cfg: ModelConfig, kind: str) -> int:
    """Key-conv width of a ``kind`` slot: MoBA slots of kconv configs
    only."""
    m = cfg.attention.moba
    return m.key_conv_width if kind == "moba" and m is not None else 0


def attention_shapes(cfg: ModelConfig, kind: str) -> dict:
    """Leaf shapes of one ``kind`` attention layer's params
    (``init_attention``)."""
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    shapes = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
              "wo": (h * dh, d)}
    if cfg.attention.qk_norm:
        shapes["q_norm_scale"] = (dh,)
        shapes["k_norm_scale"] = (dh,)
    width = _key_conv_width(cfg, kind)
    if width:
        shapes["key_conv"] = (width, hkv, dh)
    return shapes


def init_attention(gen: torch.Generator, cfg: ModelConfig, kind: str,
                   lead: Tuple[int, ...] = ()) -> dict:
    shapes = attention_shapes(cfg, kind)
    conv = shapes.pop("key_conv", None)
    p = _init_leaves(gen, shapes, lead)
    if conv is not None:
        p["key_conv"] = init_key_conv(gen, *conv, lead=lead)
    return p


def _split_heads(x, n_heads, dh):
    b, n, _ = x.shape
    return x.reshape(b, n, n_heads, dh).permute(0, 2, 1, 3)


def _uses_rope(cfg: ModelConfig, kind: str) -> bool:
    a = cfg.attention
    if not a.use_rope:
        return False
    if kind == "moba":
        return a.rope_on_moba
    return True


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    *, positions: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    backend: str = "reference",
                    page_state: Optional[dict] = None,
                    head_top_k: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self attention layer.  Returns (out, cache).

    ``backend`` names a registered attention backend (``core.backends``).
    ``cache`` is None (cache-free) or a paged pool from
    ``serving.paged_cache`` (recognised by its ``pages_k`` leaf), which
    then needs ``page_state`` = {block_table (B,npg), kv_len (B,)
    pre-step lengths, q_len (B,) new tokens this step, active (B,) bool}
    from the scheduler.  The pool is updated in place.

    ``head_top_k``: optional (H,) int32 per-query-head routing budgets
    in [1, moba.top_k] from an adaptive routing profile.  Only the paged
    MoBA paths read it; dense and swa layers ignore it.
    """
    dt = x.dtype
    a = cfg.attention
    b, n, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    q = _split_heads(x @ wcast(p["wq"], dt), h, dh)
    k = _split_heads(x @ wcast(p["wk"], dt), hkv, dh)
    v = _split_heads(x @ wcast(p["wv"], dt), hkv, dh)
    if a.qk_norm and "q_norm_scale" in p:
        q = rms_norm(q, p["q_norm_scale"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm_scale"], cfg.rms_norm_eps)

    if positions is None:
        positions = torch.arange(n, device=x.device)
    if _uses_rope(cfg, kind):
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)

    conv_w = p.get("key_conv") if kind == "moba" else None
    if cache is not None:
        if "pages_k" not in cache:
            raise ValueError("only paged caches are ported; the dense "
                             "per-sequence cache comes later (ROADMAP.md)")
        o, cache = _paged_attend(q, k, v, cache, page_state, cfg, kind,
                                 positions, backend, conv_w, head_top_k)
    else:
        if conv_w is not None:     # routing and attention see conv'd keys
            k = apply_key_conv(conv_w, k)
        o = attention_dispatch(a, kind, q, k, v, q_positions=positions,
                               backend=backend)
    o = o.permute(0, 2, 1, 3).reshape(b, n, h * dh)
    return o @ wcast(p["wo"], dt), cache


def _paged_attend(q, k, v, cache, page_state, cfg: ModelConfig, kind: str,
                  positions, backend: str, conv_w=None, head_top_k=None):
    """Paged-cache attention: append new K/V through the block table, then
    attend via the backend resolved for (kind, phase, paged).  MoBA decode
    routes on the per-page centroid cache and reads only the selected
    pages; swa decode gathers only the window's pages.  Prefill is ragged
    (right-padded rows of ``q_len`` valid tokens) and backend-shared;
    ``page_state['chunked']`` selects the chunk-aware prefill that
    attends through the block table to earlier chunks.

    Key conv (``conv_w``): keys are convolved before the page write, so
    centroids and attention see convolved keys.  The raw-key left
    context lives in the pool's per-slot ring ``key_conv_state``:
    decode rows are the slots, prefill rows address it through
    ``page_state['slots']``.  Fresh rows (``kv_len`` 0) and padding rows
    read a zero state, which makes a recycled slot's old ring harmless.
    The ring is updated in place: inactive decode slots keep theirs, and
    prefill writes only active rows with a slot, with no host sync.

    ``head_top_k`` (H,) reaches MoBA layers as the (Hkv, G) budgets every
    paged routing path takes (h = hkv·G + g): a view of an int32 tensor
    already on the card, so an adaptive step launches nothing more."""
    from repro_torch.core import backends as B
    from repro_torch.core import key_conv as KC
    from repro_torch.serving import paged_cache as PC

    if page_state is None:
        raise ValueError("paged cache requires page_state")
    a = cfg.attention
    n = q.shape[2]
    bt = page_state["block_table"]
    kvl = page_state["kv_len"]
    q_len = page_state["q_len"]
    active = page_state["active"]
    post_len = kvl + q_len                     # lengths after this step
    needs_conv = conv_w is not None
    htk = None
    adaptive = head_top_k is not None and kind == "moba"
    if adaptive:
        hkv = cfg.num_kv_heads
        htk = torch.as_tensor(head_top_k, dtype=torch.int32,
                              device=q.device).reshape(
                                  hkv, cfg.num_heads // hkv)
    if needs_conv and "key_conv_state" not in cache:
        from repro_torch.serving.scheduler import UnsupportedFeatureError
        raise UnsupportedFeatureError(
            "key_conv", "paged pool lacks the per-slot raw-key ring; "
                        "build caches with init_paged_caches(..., "
                        "max_seqs > 0) for key-conv configs")
    if n == 1:                                 # decode: one token per seq
        be = B.resolve(backend, kind=kind, phase="decode", cache="paged",
                       key_conv=needs_conv, adaptive=adaptive)
        if needs_conv:
            ring = cache["key_conv_state"]     # decode rows ARE the slots
            k, stepped = KC.apply_key_conv_decode(conv_w, k, ring)
            ring.copy_(torch.where(active[:, None, None, None], stepped,
                                   ring))
        PC.paged_append_decode(cache, bt, kvl, active, k, v)
        o = be.paged_decode(a, kind, q, cache, bt, post_len,
                            positions=positions, head_top_k=htk)
        return o, cache
    # ragged prefill (fresh one-shot, or one chunk of a chunked prompt)
    be = B.resolve(backend, kind=kind, phase="prefill", cache="paged",
                   key_conv=needs_conv, adaptive=adaptive)
    if needs_conv:
        ring = cache["key_conv_state"]
        slots = page_state["slots"]            # (B,) row -> sequence slot
        state = ring[slots.clamp(min=0).long()]
        fresh = (kvl == 0) | (slots < 0)
        state = torch.where(fresh[:, None, None, None],
                            torch.zeros_like(state), state)
        k_raw = k
        k = KC.apply_key_conv_with_state(conv_w, k, state)
        PC.write_ring_rows(cache, slots, active & (slots >= 0),
                           KC.key_conv_state_update(state, k_raw, q_len))
    PC.paged_append_prefill(cache, bt, q_len, k, v, kv_len=kvl)
    if page_state.get("chunked"):
        o = be.paged_chunk_prefill(a, kind, q, cache, bt, kvl, q_len,
                                   head_top_k=htk)
    else:
        o = be.paged_prefill(a, kind, q, k, v, post_len=post_len,
                             positions=torch.arange(n, device=q.device),
                             head_top_k=htk)
    return o, cache
