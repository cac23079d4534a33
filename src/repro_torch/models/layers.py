"""Model primitives: RMSNorm, RoPE, SwiGLU MLP, GQA attention layers and
latent attention (MLA).

Functional style as in the reference: params are plain dicts of tensors
(the JAX package's layout, so one set of weights feeds both), and
``apply(params, x) -> y``.  Compute in ``cfg.dtype`` (bf16 by default),
params in fp32; all attention math fp32.

Key-conv caching: the depthwise conv is causal, so a convolved key never
changes once written.  Both cache kinds store *convolved* keys plus the
last W-1 raw keys as state for the single-step decode conv, so routing
and attention always see the same convolved keys.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import routing
from repro_torch.core.attention import attention_dispatch
from repro_torch.core.key_conv import (apply_key_conv, apply_key_conv_decode,
                                       init_key_conv, key_conv_state_init)


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
    if not a.use_rope or kind == "cross":
        return False
    if kind == "moba":
        return a.rope_on_moba
    return True


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    *, positions: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    backend: str = "reference",
                    cross_kv: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    page_state: Optional[dict] = None,
                    head_top_k: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self (or cross) attention layer.  Returns (out, cache).

    ``cross_kv`` (B, M, d_model): keys and values are projected from it
    instead of ``x``, take no RoPE, and attend without a causal mask or a
    cache.  The ``cross`` kind takes no RoPE on its queries either and
    runs as dense attention; ``causal=False`` lifts the causal mask of
    dense attention (a bidirectional encoder).  MoBA's mask is
    ``MoBAConfig.causal``'s, whatever ``causal`` says
    (``core/backends.py``).

    ``backend`` names a registered attention backend (``core.backends``).
    ``cache`` is None (cache-free), the dense per-sequence cache of
    :func:`init_cache`, or a paged pool from ``serving.paged_cache``
    (recognised by its ``pages_k`` leaf), which then needs ``page_state``
    = {block_table (B,npg), kv_len (B,) pre-step lengths, q_len (B,) new
    tokens this step, active (B,) bool} from the scheduler.  Either cache
    is updated in place; a dense cache comes back as a new dict whose
    host-int ``len`` counts the tokens written.

    ``head_top_k``: optional (H,) int32 per-query-head routing budgets
    in [1, moba.top_k] from an adaptive routing profile.  Only the paged
    MoBA paths read it; dense and swa layers ignore it.
    """
    dt = x.dtype
    a = cfg.attention
    b, n, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    q = _split_heads(x @ wcast(p["wq"], dt), h, dh)
    src = x if cross_kv is None else cross_kv
    k = _split_heads(src @ wcast(p["wk"], dt), hkv, dh)
    v = _split_heads(src @ wcast(p["wv"], dt), hkv, dh)
    if a.qk_norm and "q_norm_scale" in p:
        q = rms_norm(q, p["q_norm_scale"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm_scale"], cfg.rms_norm_eps)

    given = positions
    if positions is None:
        positions = torch.arange(n, device=x.device)
    if _uses_rope(cfg, kind):
        q = apply_rope(q, positions, a.rope_theta)
        if cross_kv is None:
            k = apply_rope(k, positions, a.rope_theta)

    conv_w = p.get("key_conv") if kind == "moba" else None
    if cross_kv is not None or kind == "cross":
        # cross attention: dense, no cache (K/V recomputed every step)
        o = attention_dispatch(a, "dense" if kind == "cross" else kind,
                               q, k, v, q_positions=positions,
                               backend=backend,
                               causal=causal and cross_kv is None)
        cache = None
    elif cache is not None and "pages_k" in cache:
        o, cache = _paged_attend(q, k, v, cache, page_state, cfg, kind,
                                 positions, backend, conv_w, head_top_k)
    elif cache is not None:
        o, cache = _dense_cache_attend(q, k, v, cache, cfg, kind, positions,
                                       backend, conv_w)
    else:
        if conv_w is not None:     # routing and attention see conv'd keys
            k = apply_key_conv(conv_w, k)
        # a sequence over its own keys: dense and SWA attention default to
        # these positions, and without them the flash backend may run the
        # banded kernels; MoBA takes them (the sp backend sends them)
        q_pos = positions if given is not None or kind == "moba" else None
        o = attention_dispatch(a, kind, q, k, v, q_positions=q_pos,
                               backend=backend, causal=causal)
    o = o.permute(0, 2, 1, 3).reshape(b, n, h * dh)
    return o @ wcast(p["wo"], dt), cache


# ------------------------------------------------------ latent attention
def mla_shapes(cfg) -> dict:
    """Leaf shapes of one latent attention layer (``cfg`` a
    ``LatentMoEConfig``): ``wq`` to every head's q/k-wide query,
    ``wkv_a`` to the latent and the shared RoPE key, ``kv_norm_scale``,
    ``wkv_b`` from the latent to every head's [k_nope, v], ``wo``."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    return {"wq": (d, h * m.qk_head_dim),
            "wkv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm_scale": (m.kv_lora_rank,),
            "wkv_b": (m.kv_lora_rank,
                      h * (m.qk_nope_head_dim + m.v_head_dim)),
            "wo": (h * m.v_head_dim, d)}


def init_mla(gen: torch.Generator, cfg) -> dict:
    return _init_leaves(gen, mla_shapes(cfg), ())


def mla_kv(p: dict, x: torch.Tensor, cfg, positions):
    """Latent attention's keys and values: x (B, N, d_model) down to the
    latent and the RoPE key, the latent's RMSNorm, up to every head's
    k_nope and v; RoPE on the key part that every head shares.  Returns
    k (B, H, N, qk_head_dim) and v (B, H, N, v_head_dim)."""
    m, h, dt = cfg.mla, cfg.num_heads, x.dtype
    b, n, _ = x.shape
    c, k_pe = (x @ wcast(p["wkv_a"], dt)).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c = rms_norm(c, p["kv_norm_scale"], cfg.rms_norm_eps)
    kv = _split_heads(c @ wcast(p["wkv_b"], dt), h,
                      m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_pe = apply_rope(k_pe[:, None], positions, cfg.attention.rope_theta)
    k = torch.cat([k_nope, k_pe.expand(b, h, n, m.qk_rope_head_dim)],
                  dim=-1)
    return k, v


def apply_mla(p: dict, x: torch.Tensor, cfg, *, positions=None,
              backend: str = "flash") -> torch.Tensor:
    """Latent attention (DeepSeek-V2 §2.1, no query latent) over a
    sequence's own keys, cache-free (training): q = x·W_q split into
    q_nope and q_pe, RoPE (half-split pairs) on q_pe and the shared key
    part, q/k ``qk_head_dim`` and v ``v_head_dim`` wide, softmax scale
    qk_head_dim^-½, then ``attention.kind`` (MoBA routes on the whole
    q/k width) and W_o.  The latent projection, its norm, the
    up-projection and the key's RoPE run in a ``model.mla.kv`` region."""
    m, h, dt = cfg.mla, cfg.num_heads, x.dtype
    b, n, _ = x.shape
    if positions is None:
        positions = torch.arange(n, device=x.device)
    q = _split_heads(x @ wcast(p["wq"], dt), h, m.qk_head_dim)
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q = torch.cat([q_nope, apply_rope(q_pe, positions,
                                      cfg.attention.rope_theta)], dim=-1)
    with tracing.region("model.mla.kv") as r:
        k, v = r.output(*mla_kv(p, r.input(x), cfg, positions))
    o = attention_dispatch(cfg.attention, cfg.attention.kind, q, k, v,
                           q_positions=positions, backend=backend)
    o = o.permute(0, 2, 1, 3).reshape(b, n, h * m.v_head_dim)
    return o @ wcast(p["wo"], dt)


def _dense_cache_attend(q, k, v, cache, cfg: ModelConfig, kind: str,
                        positions, backend: str, conv_w=None):
    """Dense-cache attention (the fixed serving loop): write the new K/V
    at ``cache['len']`` (a host int, so neither the write nor any slice
    needs a device sync), update the MoBA centroid cache, then attend.

    Centroids, in fp32 as in the reference: a decode step's rank-1 update
    ``(old·m + k) / (m + 1)`` of the written block (m its earlier
    tokens); a prefill rebuilds them over the valid prefix.  Key conv: a
    decode step convolves its key against the raw-key state; a prefill
    convolves the whole prefix (a fresh sequence) and keeps its raw tail
    as state.

    MoBA prefill attends over the valid prefix ``[:len+n]`` only: the
    queries are then the suffix of the keys, which ``flash_moba``
    assumes.  (The reference hands it the whole cache, and its ``flash``
    path then places the queries at the cache's end.)  Dense and SWA
    layers mask the whole cache by ``kv_len``; MoBA decode routes on the
    centroid cache.

    A context-parallel cache (:func:`init_cache` with ``segments``) holds
    a MoBA slot's k, v and centroids as per-shard sequence segments:
    each new token goes to the segment that owns its position, and
    attention runs over the segments through the active
    ``distributed/moba_sp.py`` group (the ``sp`` backend)."""
    n = q.shape[2]
    start = cache["len"]
    end = start + n
    new = dict(cache, len=end)
    if conv_w is not None:
        state = cache["key_conv_state"]
        if n == 1:
            k, stepped = apply_key_conv_decode(conv_w, k, state)
        else:
            depth = state.shape[2]
            raw = torch.cat([state, k.to(state.dtype)], dim=2)
            stepped = raw[:, :, raw.shape[2] - depth:]
            k = apply_key_conv(conv_w, k)
        state.copy_(stepped)
    if isinstance(cache["k"], list):
        return _segments_attend(q, k, v, cache, cfg, kind, positions,
                                backend, start), new
    cache["k"][:, :, start:end] = k.to(cache["k"].dtype)
    cache["v"][:, :, start:end] = v.to(cache["v"].dtype)
    if "centroids" in cache:
        bs = cfg.attention.moba.block_size
        c = cache["centroids"]
        if n == 1:
            j, m = start // bs, start % bs
            old = c[:, :, j:j + 1]
            c[:, :, j:j + 1] = (old * m + k.float()) / old.new_full(
                (), m + 1)
        else:
            c.copy_(routing.block_centroids(cache["k"], bs,
                                            kv_len=end).float())
    a = cfg.attention
    if kind == "moba" and n > 1:
        o = attention_dispatch(a, kind, q, cache["k"][:, :, :end],
                               cache["v"][:, :, :end],
                               q_positions=positions, backend=backend)
    else:
        o = attention_dispatch(a, kind, q, cache["k"], cache["v"],
                               q_positions=positions, kv_len=end,
                               backend=backend,
                               centroids=cache.get("centroids"))
    return o, new


def _segments_attend(q, k, v, cache, cfg: ModelConfig, kind: str,
                     positions, backend: str, start: int):
    """The context-parallel branch of :func:`_dense_cache_attend`: the
    new tokens go to the segments that own their positions; a prefill
    (a fresh sequence) attends its own keys, which the ``sp`` backend
    copies to every shard, and a decode step attends over the segments
    in place."""
    from repro_torch.distributed import moba_sp
    group = moba_sp.active_group()
    if group is None or group.size != len(cache["k"]):
        raise ValueError(f"a cache of {len(cache['k'])} sequence segments "
                         f"needs an active context-parallel group of as "
                         f"many shards (distributed/moba_sp.use_group)")
    n = q.shape[2]
    if n > 1 and start:
        raise ValueError("a context-parallel prefill fills an empty cache")
    moba_sp.append_segments(cache["k"], cache["v"], cache.get("centroids"),
                            k, v, start, cfg.attention.moba.block_size,
                            group)
    if n > 1:
        return attention_dispatch(cfg.attention, kind, q, k, v,
                                  q_positions=positions, backend=backend)
    return attention_dispatch(cfg.attention, kind, q, cache["k"],
                              cache["v"], q_positions=positions,
                              kv_len=start + 1, backend=backend,
                              centroids=cache.get("centroids"))


def init_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", groups: int = 0,
               segments=None) -> dict:
    """Dense per-sequence cache of one ``kind`` slot: ``k``/``v`` (B,
    Hkv, max_len, d) in ``dtype``, ``len`` (a host int, 0), and on MoBA
    slots the fp32 incremental centroid cache (B, Hkv, nb, d) and, with
    key conv, the raw-key state (B, Hkv, W-1, d).  ``groups > 0``
    prepends the layer-group axis to every tensor leaf.

    ``segments`` (a list of S devices, context parallelism): a MoBA
    slot's ``k``, ``v`` and ``centroids`` become lists of S sequence
    segments, segment s on ``segments[s]`` holding positions [s·N/S,
    (s+1)·N/S); ``max_len`` must be a multiple of S times the block
    size.  The key-conv state and other slots stay on ``device``."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    lead = (groups,) if groups else ()

    def zeros(*shape, dt=dtype, dev=device):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    m = cfg.attention.moba
    if kind == "moba" and m is not None and segments:
        ns = len(segments)
        if max_len % (ns * m.block_size):
            raise ValueError(f"max_len {max_len} does not split into {ns} "
                             f"segments of whole {m.block_size}-token "
                             f"blocks")
        n_local = max_len // ns
        c = {name: [zeros(batch, hkv, n, dh, dt=dt, dev=dev)
                    for dev in segments]
             for name, n, dt in (("k", n_local, dtype), ("v", n_local, dtype),
                                 ("centroids", n_local // m.block_size,
                                  torch.float32))}
        c["len"] = 0
    else:
        c = {"k": zeros(batch, hkv, max_len, dh),
             "v": zeros(batch, hkv, max_len, dh), "len": 0}
    if kind == "moba" and m is not None:
        if not segments:
            nb = -(-max_len // m.block_size)
            c["centroids"] = zeros(batch, hkv, nb, dh, dt=torch.float32)
        if m.key_conv_width:
            state = key_conv_state_init(m.key_conv_width, batch, hkv, dh,
                                        dtype=dtype, device=device)
            c["key_conv_state"] = (state.expand(lead + state.shape)
                                   .contiguous())
    return c


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
    prefill writes only active rows with a slot, with no host sync.  Pools
    with per-page ``key_conv_tails`` (prefix-cache engines) record the raw
    keys landing in each page's last W-1 positions right after the page
    write, in decode and in prefill.

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
        k_raw = k
        if needs_conv:
            ring = cache["key_conv_state"]     # decode rows ARE the slots
            k, stepped = KC.apply_key_conv_decode(conv_w, k, ring)
            ring.copy_(torch.where(active[:, None, None, None], stepped,
                                   ring))
        PC.paged_append_decode(cache, bt, kvl, active, k, v)
        if needs_conv and "key_conv_tails" in cache:
            PC.update_key_conv_tails(cache, bt, kvl, active.to(torch.int32),
                                     k_raw)
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
    if needs_conv and "key_conv_tails" in cache:
        PC.update_key_conv_tails(cache, bt, kvl, q_len, k_raw)
    if page_state.get("chunked"):
        o = be.paged_chunk_prefill(a, kind, q, cache, bt, kvl, q_len,
                                   head_top_k=htk)
    else:
        o = be.paged_prefill(a, kind, q, k, v, post_len=post_len,
                             positions=torch.arange(n, device=q.device),
                             head_top_k=htk)
    return o, cache
