"""Mixture of Block Attention — plain PyTorch reference and paged paths.

The reference path materializes the N×N mask and is the correctness
oracle; the paged functions are the serving engine's plain versions
(the ``xla`` backend, and the CPU side of the Hopper decode kernel in
``kernels/moba_decode.py``).

Shapes: q (B, H, Nq, d); k, v (B, Hkv, N, d) with H % Hkv == 0 (GQA —
query heads grouped onto kv heads by reshape, no KV duplication).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoBAConfig
from repro_torch.core import routing

NEG_INF = routing.NEG_INF

# Calibration hook (``core.adaptive.capture_routing_scores``): when set to
# a callable, moba_selection feeds it (scores, q_positions) per call.
_score_sink = None


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def _group_queries(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    b, h, n, d = q.shape
    g = h // num_kv_heads
    return q.reshape(b, num_kv_heads, g, n, d)


def _truncate_head_topk(idx: torch.Tensor, sel_valid: torch.Tensor,
                        head_top_k: Optional[torch.Tensor]):
    """Truncate a score-sorted (B, Hkv, G, L, k) page selection to
    per-head budgets.  ``head_top_k``: (Hkv, G) int32 in [1, k]; slots
    ranked >= the head's budget become invalid.  Rank 0 is the forced
    own page (POS_INF), so budgets >= 1 always keep it."""
    if head_top_k is None:
        return idx, sel_valid
    keep = (torch.arange(idx.shape[-1], device=idx.device)
            < head_top_k[..., None, None])
    sel_valid = sel_valid & keep                  # (Hkv,G,1,k) broadcast
    return torch.where(sel_valid, idx, 0), sel_valid


def moba_selection(q: torch.Tensor, k: torch.Tensor, cfg: MoBAConfig,
                   q_positions: Optional[torch.Tensor] = None,
                   head_top_k: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Routing only: returns selected block ids (B, H, Nq, top_k).

    ``head_top_k``: optional (Hkv, G) int32 per-head budgets in
    [1, top_k]; truncated slots carry the sentinel block id."""
    b, hkv, n, d = k.shape
    nq = q.shape[2]
    if q_positions is None:
        q_positions = _arange(nq, q) + (n - nq)  # suffix alignment (decode)
    cents = routing.block_centroids(k, cfg.block_size)      # (B,Hkv,nb,d)
    qg = _group_queries(q, hkv)                              # (B,Hkv,G,Nq,d)
    scores = torch.einsum("bhgqd,bhnd->bhgqn", qg.float(), cents.float())
    if _score_sink is not None:
        _score_sink((scores, q_positions))
    sel = routing.select_blocks(scores, cfg.top_k, cfg.block_size,
                                q_positions, causal=cfg.causal,
                                head_top_k=head_top_k)
    return sel.reshape(b, -1, nq, cfg.top_k)


def moba_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, cfg: MoBAConfig,
                             q_positions: Optional[torch.Tensor] = None,
                             kv_len: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None,
                             head_top_k: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Oracle implementation: O(N^2) masked softmax attention where the
    mask is derived from MoBA block selection.

    mask[t, s] = selected[t, block(s)] AND s <= t (causal)   [causal mode]
    mask[t, s] = selected[t, block(s)]                       [bidirectional]
    """
    b, h, nq, d = q.shape
    _, hkv, n, _ = k.shape
    nb = -(-n // cfg.block_size)
    if q_positions is None:
        q_positions = _arange(nq, q) + (n - nq)
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    sel = moba_selection(q, k, cfg, q_positions,
                         head_top_k=head_top_k)              # (B,H,Nq,k)
    sel_mask = routing.selection_mask(sel, nb)               # (B,H,Nq,nb)
    key_block = _arange(n, q) // cfg.block_size              # (N,)
    mask = sel_mask[..., key_block]                          # (B,H,Nq,N)
    if cfg.causal:
        causal = q_positions[:, None] >= _arange(n, q)[None, :]
        mask = mask & causal[None, None]
    if kv_len is not None:
        mask = mask & (_arange(n, q)[None, None, None, :] < kv_len)

    qg = _group_queries(q, hkv).float()
    s = torch.einsum("bhgqd,bhsd->bhgqs", qg, k.float()) * scale
    s = s.reshape(b, h, nq, n)
    s = torch.where(mask, s, NEG_INF)
    # guard fully-masked rows (cannot happen causally: own block present)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    pg = p.reshape(b, hkv, -1, nq, n)
    o = torch.einsum("bhgqs,bhsd->bhgqd", pg, v.float())
    return o.reshape(b, h, nq, d).to(q.dtype)


def _topk_pages(masked: torch.Tensor, top_k: int):
    """Shared tail of paged routing: top-k over the last (page) axis,
    padded with invalid slots when the axis is shorter than ``top_k``.
    Both the decode and the chunked-prefill routes go through this so
    their selection semantics cannot drift apart.

    Returns (idx, sel_valid): selected indices (invalid slots 0) and
    their validity mask (NEG_INF-scored slots are invalid).
    """
    n = masked.shape[-1]
    kk = min(top_k, n)
    top_s, top_idx = routing.topk_desc(masked, kk)
    if kk < top_k:
        padw = top_k - kk
        top_s = torch.cat(
            [top_s, top_s.new_full(top_s.shape[:-1] + (padw,), NEG_INF)], -1)
        top_idx = torch.cat(
            [top_idx, top_idx.new_zeros(top_idx.shape[:-1] + (padw,))], -1)
    sel_valid = top_s > NEG_INF / 2
    return torch.where(sel_valid, top_idx, 0), sel_valid


def moba_paged_route(q: torch.Tensor, centroids: torch.Tensor,
                     block_table: torch.Tensor, kv_len: torch.Tensor,
                     cfg: MoBAConfig, page_size: Optional[int] = None,
                     head_top_k: Optional[torch.Tensor] = None):
    """Decode-time page routing on the per-page centroid cache.

    Shared by the plain gather path and the Hopper decode kernel's
    wrapper so both attend to exactly the same pages: causal over pages,
    own (last) page forced, per-sequence lengths, top-k padded with
    invalid slots when the table is shorter than ``top_k``.

    q:           (B, H, 1, d)
    centroids:   (P, Hkv, d) fp32 per-page centroid pool
    block_table: (B, npg) int32 physical page ids, -1 = unassigned
    kv_len:      (B,) int32 post-append valid lengths

    Returns (idx, sel_valid): logical page ids (B, Hkv, G, 1, top_k)
    int64 (invalid slots 0) and their validity mask.  ``head_top_k``
    ((Hkv, G) int32 in [1, top_k]) truncates each head's score-sorted
    selection to its budget.
    """
    ps = page_size or cfg.block_size  # one page == one routable block
    idx, sel_valid = _topk_pages(paged_route_scores(
        q, centroids, block_table, kv_len, ps), cfg.top_k)
    return _truncate_head_topk(idx, sel_valid, head_top_k)


def paged_route_scores(q: torch.Tensor, centroids: torch.Tensor,
                       block_table: torch.Tensor, kv_len: torch.Tensor,
                       page_size: int) -> torch.Tensor:
    """The masked page scores :func:`moba_paged_route` takes its top-k
    of: (B, Hkv, G, 1, npg) fp32 dots of the unscaled query with each
    page's centroid, ``NEG_INF`` for pages past ``kv_len`` or unassigned,
    ``POS_INF`` for the own (last) page."""
    hkv = centroids.shape[1]
    npg = block_table.shape[1]
    ps = page_size
    tbl = block_table.clamp(min=0).long()
    cents = centroids[tbl].permute(0, 2, 1, 3)               # (B,Hkv,npg,d)
    qg = _group_queries(q, hkv).float()                      # (B,Hkv,G,1,d)
    scores = torch.einsum("bhgqd,bhnd->bhgqn", qg, cents.float())
    pages = _arange(npg, q)
    valid = (pages[None, :] * ps < kv_len[:, None]) & (block_table >= 0)
    own = torch.clamp(kv_len - 1, min=0) // ps               # (B,)
    is_own = pages[None, :] == own[:, None]                  # (B,npg)
    masked = torch.where(valid[:, None, None, None], scores, NEG_INF)
    return torch.where(is_own[:, None, None, None], routing.POS_INF, masked)


def moba_paged_decode_attention(q: torch.Tensor, pages_k: torch.Tensor,
                                pages_v: torch.Tensor,
                                centroids: torch.Tensor,
                                block_table: torch.Tensor,
                                kv_len: torch.Tensor, cfg: MoBAConfig,
                                scale: Optional[float] = None,
                                scales_k: Optional[torch.Tensor] = None,
                                scales_v: Optional[torch.Tensor] = None,
                                head_top_k: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Single-step decode against a paged cache: route on the per-page
    centroid cache, then gather only the ``top_k`` selected pages through
    the block table — O(N/B·d) routing reads + O(k·B·d) attention reads
    per kv head.  The plain version of the Hopper decode kernel.

    q:           (B, H, 1, d)
    pages_k/v:   (P, page_size, Hkv, d) shared pool (one layer slot)
    centroids:   (P, Hkv, d) fp32 per-page centroid cache
    block_table: (B, npg) int32 physical page ids, -1 = unassigned
    kv_len:      (B,) int32 valid lengths *including* the token appended
                 this step (call after the cache append)
    scales_k/v:  (P, Hkv) fp32 per-page dequant scales of a quantized
                 pool (None = unquantized).  Routing never sees them.
    head_top_k:  (Hkv, G) int32 per-head budgets in [1, top_k] (adaptive
                 routing), or None for the static top_k.
    """
    ps = pages_k.shape[1]
    idx, sel_valid = moba_paged_route(q, centroids, block_table, kv_len,
                                      cfg, page_size=ps,
                                      head_top_k=head_top_k)
    return moba_paged_attend(q, pages_k, pages_v, block_table, kv_len, idx,
                             sel_valid, scale=scale, scales_k=scales_k,
                             scales_v=scales_v)


def moba_paged_attend(q: torch.Tensor, pages_k: torch.Tensor,
                      pages_v: torch.Tensor, block_table: torch.Tensor,
                      kv_len: torch.Tensor, idx: torch.Tensor,
                      sel_valid: torch.Tensor,
                      scale: Optional[float] = None,
                      scales_k: Optional[torch.Tensor] = None,
                      scales_v: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The attention half of :func:`moba_paged_decode_attention`, on a
    given selection: ``idx``/``sel_valid`` (B, Hkv, G, 1, top_k) as
    :func:`moba_paged_route` returns them.  Gathers only the selected
    pages through the block table (dequantized by ``scales_k``/``v``)
    and takes one softmax over their valid tokens."""
    b, h, _, d = q.shape
    _, ps, hkv, _ = pages_k.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = _group_queries(q, hkv).float()                      # (B,Hkv,G,1,d)
    tbl = block_table.clamp(min=0).long()
    phys = tbl[_arange(b, q)[:, None, None, None, None], idx]

    # gather only the selected pages, per kv head: (B,Hkv,G,1,k,ps,d)
    heads = _arange(hkv, q)[None, :, None, None, None]
    kg = pages_k.permute(2, 0, 1, 3)[heads, phys].float()
    vg = pages_v.permute(2, 0, 1, 3)[heads, phys].float()
    if scales_k is not None:
        # one scalar per selected (page, kv head), broadcast over (ps, d)
        kg = kg * scales_k[phys, heads][..., None, None]
        vg = vg * scales_v[phys, heads][..., None, None]
    s = torch.einsum("bhgqd,bhgqkld->bhgqkl", qg, kg) * scale
    pos = idx[..., :, None] * ps + _arange(ps, q)            # logical pos
    tok_valid = ((pos < kv_len[:, None, None, None, None, None])
                 & sel_valid[..., None])
    s = torch.where(tok_valid, s, NEG_INF)
    sf = s.reshape(*s.shape[:-2], -1)
    p = torch.softmax(sf, dim=-1).reshape(s.shape)
    o = torch.einsum("bhgqkl,bhgqkld->bhgqd", p, vg)
    return o.reshape(b, h, 1, d).to(q.dtype)


def moba_paged_prefill_route(q: torch.Tensor, centroids: torch.Tensor,
                             block_table: torch.Tensor,
                             kv_len: torch.Tensor, q_len: torch.Tensor,
                             cfg: MoBAConfig,
                             page_size: Optional[int] = None,
                             head_top_k: Optional[torch.Tensor] = None):
    """Chunked-prefill page routing on the per-page centroid cache.

    Multi-token sibling of :func:`moba_paged_route`: query j of row i sits
    at absolute position ``kv_len[i] + j`` and scores every logical page
    of its sequence, with future pages masked, the own page forced, and
    unassigned table entries invalid.  Call *after* the chunk's keys (and
    centroid recomputes) are appended, so complete pages carry exactly
    the centroids one-shot prefill would compute.

    q: (B, H, L, d) right-padded chunk queries; centroids: (P, Hkv, d);
    block_table: (B, npg); kv_len: (B,) pre-chunk lengths; q_len: (B,)
    valid chunk tokens per row.

    Returns (idx, sel_valid): logical page ids (B, Hkv, G, L, top_k)
    (invalid slots 0) and their validity mask; ``head_top_k`` as in
    :func:`moba_paged_route`, applied before the row mask.
    """
    nq = q.shape[2]
    hkv = centroids.shape[1]
    npg = block_table.shape[1]
    ps = page_size or cfg.block_size  # one page == one routable block
    tbl = block_table.clamp(min=0).long()
    cents = centroids[tbl].permute(0, 2, 1, 3)               # (B,Hkv,npg,d)
    qg = _group_queries(q, hkv).float()                      # (B,Hkv,G,L,d)
    scores = torch.einsum("bhgqd,bhnd->bhgqn", qg, cents.float())
    pos = kv_len[:, None] + _arange(nq, q)                   # (B,L) abs pos
    own = pos // ps                                          # (B,L)
    blk = _arange(npg, q)
    future = blk[None, None, :] > own[:, :, None]            # (B,L,npg)
    is_own = blk[None, None, :] == own[:, :, None]
    assigned = (block_table >= 0)[:, None, :]                # (B,1,npg)
    # broadcast (B,L,npg) masks into (B,Hkv,G,L,npg)
    masked = torch.where((future | ~assigned)[:, None, None], NEG_INF,
                         scores)
    masked = torch.where(is_own[:, None, None], routing.POS_INF, masked)
    idx, sel_valid = _topk_pages(masked, cfg.top_k)
    idx, sel_valid = _truncate_head_topk(idx, sel_valid, head_top_k)
    # padded query rows (beyond q_len) select nothing
    row_valid = _arange(nq, q)[None, :] < q_len[:, None]     # (B,L)
    sel_valid = sel_valid & row_valid[:, None, None, :, None]
    return torch.where(sel_valid, idx, 0), sel_valid


def moba_paged_prefill_attention(q: torch.Tensor, pages_k: torch.Tensor,
                                 pages_v: torch.Tensor,
                                 centroids: torch.Tensor,
                                 block_table: torch.Tensor,
                                 kv_len: torch.Tensor, q_len: torch.Tensor,
                                 cfg: MoBAConfig,
                                 scale: Optional[float] = None,
                                 scales_k: Optional[torch.Tensor] = None,
                                 scales_v: Optional[torch.Tensor] = None,
                                 head_top_k: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Chunked-prefill MoBA attention against a paged cache.

    The chunk's queries route on the per-page centroid cache
    (:func:`moba_paged_prefill_route`), then attend over the densified
    sequence view of the pool under the selection × causal mask — earlier
    chunks' keys are visible through the block table.  Padded query rows
    (beyond ``q_len``) select nothing and output zeros.

    q: (B, H, L, d); pages_k/v: (P, ps, Hkv, d); centroids: (P, Hkv, d);
    block_table: (B, npg); kv_len: (B,) pre-chunk lengths (the chunk and
    its centroid updates must already be appended); q_len: (B,);
    scales_k/v: (P, Hkv) fp32 per-page dequant scales of a quantized
    pool (None = unquantized), applied on the densified view, never to
    the routing centroids; head_top_k: (Hkv, G) per-head budgets or
    None.
    """
    b, h, nq, d = q.shape
    _, ps, hkv, _ = pages_k.shape
    npg = block_table.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    idx, sel_valid = moba_paged_prefill_route(q, centroids, block_table,
                                              kv_len, q_len, cfg,
                                              page_size=ps,
                                              head_top_k=head_top_k)
    sel_mask = routing.selection_mask(
        torch.where(sel_valid, idx, npg), npg)               # (B,Hkv,G,L,npg)
    pos = kv_len[:, None] + _arange(nq, q)                   # (B,L) abs pos
    key_pos = _arange(npg * ps, q)                           # logical order
    causal = pos[:, :, None] >= key_pos[None, None, :]       # (B,L,n)
    tok_sel = torch.repeat_interleave(sel_mask, ps, dim=-1)  # (B,Hkv,G,L,n)
    mask = tok_sel & causal[:, None, None]

    tbl = block_table.clamp(min=0).long()

    def densify(pool, scales):
        g = pool[tbl].float()                                # (B,npg,ps,h,d)
        if scales is not None:
            g = g * scales[tbl][:, :, None, :, None]
        return g.permute(0, 3, 1, 2, 4).reshape(b, hkv, npg * ps, d)

    kf = densify(pages_k, scales_k)
    vf = densify(pages_v, scales_v)
    qg = _group_queries(q, hkv).float()                      # (B,Hkv,G,L,d)
    s = torch.einsum("bhgqd,bhsd->bhgqs", qg, kf) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhgqs,bhsd->bhgqd", p, vf)
    return o.reshape(b, h, nq, d).to(q.dtype)
