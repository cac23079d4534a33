"""Paged KV cache with a per-page centroid cache (device side, PyTorch).

A page holds ``page_size`` tokens of K and V for every kv head of one
layer slot.  ``page_size`` equals the MoBA ``block_size``, so **one page
is exactly one routable block**: the per-page centroid cache doubles as
the decode routing table.

Layout: pools are token-major ``(num_pages, page_size, hkv, dh)`` so the
flat ``(num_pages*page_size, hkv, dh)`` scatter/gather view used by the
append paths is a free reshape.  The reference updates its pools
functionally under ``jit`` with buffer donation; here the appends write
the pools **in place** and return the same dict.

Invalid writes (padded rows, unassigned pages) were dropped by the
reference's ``scatter(mode="drop")``.  Torch indexing raises on an
out-of-range index instead, and masking with a boolean index would wait
for the device, so :func:`_scatter_rows` redirects every dropped row onto
the first kept row — same index, same bytes — which keeps the write
deterministic and free of host synchronisation.

Centroid semantics match the dense cache exactly:
  * prefill recomputes each touched page's centroid from the stored keys;
  * decode folds the new key in with one rank-1 update
    ``c ← (c·m + k)/(m+1)``.

Quantized pools (``kv_dtype`` int8/fp8, ``core/quantization.py``) carry
per-(page, kv head) fp32 ``scales_k``/``scales_v`` leaves; the appends
requantize every page they touch and the gathers dequantize.

MoBA pools of key-conv models carry a per-sequence-slot ring
``key_conv_state`` of the last ``key_conv_width - 1`` raw keys (the
conv's left context, ``models/layers.py::_paged_attend``).  It is indexed
by slot, not page, so it is not in :data:`PAGE_LEAVES`; swap moves it
with :func:`gather_ring_rows` / :func:`scatter_ring_rows`.  Engines with
the prefix cache also give them per-page ``key_conv_tails``, the raw keys
of each page's last ``width - 1`` positions: a prefix hit loads the
sequence's ring from the last matched page's tail
(:func:`load_ring_from_tails`), so the suffix prefill convolves with the
state a contiguous prefill would have carried.

The prefix cache's copy-on-write duplicates a shared page in every page
leaf (:func:`copy_pages`) before a sequence writes into it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantization as Q

# leaves indexed by physical page id on their (first non-group) axis —
# the unit that page-granular ops (COW copy, swap save/restore) move.  The
# scale leaves of quantized pools are here so a copied or swapped-in page
# comes with its own scales, not the stale ones of the page it lands on;
# the key-conv tails so a page keeps the raw keys its ring loads need.
PAGE_LEAVES = ("pages_k", "pages_v", "scales_k", "scales_v", "centroids",
               "key_conv_tails")


def resolve_page_size(cfg: ModelConfig) -> int:
    """Page size = MoBA block size when any layer routes; else 16."""
    a = cfg.attention
    if a.moba is not None and any(k == "moba" for k in cfg.layer_pattern):
        return a.moba.block_size
    return 16


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                   with_centroids: bool, dtype=torch.bfloat16,
                   device="cuda", kv_dtype: str = "fp32",
                   groups: Optional[int] = None, max_seqs: int = 0,
                   prefix_tails: bool = False) -> Dict:
    """One layer slot's pool; ``groups`` adds the leading layer-group
    axis the model's group loop indexes (``transformer.init_paged_caches``).

    ``kv_dtype`` of ``"int8"``/``"fp8"`` stores the K/V payload quantized
    with per-(page, kv head) fp32 ``scales_k``/``scales_v`` leaves (1.0 at
    init, so dequantizing a fresh page is a no-op); centroids stay fp32.
    ``"fp32"`` stores pages at ``dtype`` with no scale leaves.

    MoBA pools (``with_centroids``) of key-conv models with ``max_seqs``
    > 0 also get the ring ``key_conv_state`` (max_seqs, hkv, W-1, dh) at
    ``dtype``, never quantized: it feeds the conv that feeds the
    router.  ``prefix_tails`` (prefix-cache engines) adds the per-page
    ``key_conv_tails`` (num_pages, hkv, W-1, dh), at ``dtype`` too."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    if kv_dtype not in Q.KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                         f"expected one of {Q.KV_DTYPES}")
    pg_dtype = dtype if kv_dtype == "fp32" else Q.payload_dtype(kv_dtype)
    lead = () if groups is None else (groups,)
    pool = {"pages_k": torch.zeros(lead + (num_pages, page_size, hkv, dh),
                                   dtype=pg_dtype, device=device),
            "pages_v": torch.zeros(lead + (num_pages, page_size, hkv, dh),
                                   dtype=pg_dtype, device=device)}
    if kv_dtype != "fp32":
        for name in ("scales_k", "scales_v"):
            pool[name] = torch.ones(lead + (num_pages, hkv),
                                    dtype=torch.float32, device=device)
    if with_centroids:
        pool["centroids"] = torch.zeros(lead + (num_pages, hkv, dh),
                                        dtype=torch.float32, device=device)
        a = cfg.attention
        width = a.moba.key_conv_width if a.moba is not None else 0
        if width and max_seqs:
            pool["key_conv_state"] = torch.zeros(
                lead + (max_seqs, hkv, width - 1, dh), dtype=dtype,
                device=device)
            if prefix_tails:
                pool["key_conv_tails"] = torch.zeros(
                    lead + (num_pages, hkv, width - 1, dh), dtype=dtype,
                    device=device)
    return pool


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``dst[idx[i]] = vals[i]`` for every row with ``ok[i]``; other rows
    write nothing.  Dropped rows are sent to the first kept row's index
    with that row's value, so duplicate indices carry identical bytes;
    with no kept row at all, row 0 of ``dst`` is written back unchanged.
    fp8 rows are copied as bytes (``index_copy_`` has no fp8 kernel)."""
    n = idx.shape[0]
    ok = ok.reshape(n)
    first = torch.argmax(ok.to(torch.int32))       # first kept row (or 0)
    src = torch.where(ok, torch.arange(n, device=ok.device), first)
    any_ok = ok.any()
    tgt = torch.where(any_ok, idx.reshape(n)[src], 0).long()
    v = torch.where(any_ok, vals[src].to(dst.dtype), dst[0])
    if dst.dtype == torch.float8_e4m3fn:
        dst, v = dst.view(torch.uint8), v.view(torch.uint8)
    dst.index_copy_(0, tgt, v)


def write_ring_rows(cache: Dict, slots: torch.Tensor, ok: torch.Tensor,
                    rows: torch.Tensor) -> None:
    """``key_conv_state[slots[i]] = rows[i]`` for every prefill row with
    ``ok[i]``, in place (one layer group's pool)."""
    _scatter_rows(cache["key_conv_state"], slots, ok, rows)


def update_key_conv_tails(cache: Dict, block_table: torch.Tensor,
                          kv_len: torch.Tensor, q_len: torch.Tensor,
                          k_raw: torch.Tensor) -> Dict:
    """Keep each page's raw-key tail through an append, in place (one
    layer group's pool, right after the page write).

    k_raw (B, hkv, L, dh) are the pre-conv keys row i writes at absolute
    positions [kv_len[i], kv_len[i] + q_len[i]); those landing in a page's
    last ``width - 1`` positions are recorded in that page's tail.  Decode
    passes L == 1 and the active mask as ``q_len``.  Rows that write no
    tail go through :func:`_scatter_rows`: nothing of theirs is written,
    and no host sync decides it."""
    tails = cache["key_conv_tails"]           # (P, hkv, depth, dh)
    num_pages, hkv, depth, dh = tails.shape
    ps = cache["pages_k"].shape[1]
    b, _, length, _ = k_raw.shape
    npg = block_table.shape[1]
    dev = k_raw.device
    pos = kv_len[:, None] + torch.arange(length, device=dev)  # (B,L) abs
    logical = torch.clamp(pos // ps, max=npg - 1)
    phys = block_table.gather(1, logical.long())              # (B,L)
    ti = pos % ps - (ps - depth)                             # tail index
    valid = ((torch.arange(length, device=dev)[None, :] < q_len[:, None])
             & (phys >= 0) & (ti >= 0))
    heads = torch.arange(hkv, device=dev)
    row = ((phys[..., None] * hkv + heads) * depth
           + ti[..., None])                                  # (B,L,hkv)
    vals = k_raw.permute(0, 2, 1, 3)                         # (B,L,hkv,dh)
    _scatter_rows(tails.view(num_pages * hkv * depth, dh), row.reshape(-1),
                  valid[..., None].expand(b, length, hkv),
                  vals.reshape(b * length * hkv, dh))
    return cache


def paged_append_decode(cache: Dict, block_table: torch.Tensor,
                        kv_len: torch.Tensor, active: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor) -> Dict:
    """Write one token per active sequence at position ``kv_len[i]``, in
    place.  k_new/v_new: (B, hkv, 1, dh) in compute dtype.  Updates the
    written page's centroid incrementally.  Inactive rows write nothing.

    Quantized pools requantize the whole tail page read-modify-write:
    gather → dequantize → insert the token → amax over the now-valid
    positions → scatter payload and scale back.  The centroid update
    folds the incoming key in, never reading the pool, so routing state
    is identical across ``kv_dtype`` modes."""
    pk, pv = cache["pages_k"], cache["pages_v"]
    num_pages, ps, hkv, dh = pk.shape
    npg = block_table.shape[1]
    page_idx = kv_len // ps
    off = kv_len % ps
    phys = block_table.gather(
        1, page_idx.clamp(max=npg - 1)[:, None].long())[:, 0]
    ok = active & (phys >= 0) & (page_idx < npg)
    tok_k = k_new[:, :, 0]                                   # (B,hkv,dh)
    tok_v = v_new[:, :, 0]
    if "scales_k" in cache:
        kv_dt = Q.kv_dtype_of(pk.dtype)
        ph = phys.clamp(min=0).long()
        pos = torch.arange(ps, device=pk.device)[None, :]
        onehot = (pos == off[:, None])[:, :, None, None]     # (B,ps,1,1)
        vmask = (pos <= off[:, None])[:, :, None, None]      # valid incl new

        def requant(pool, scales, tok):
            page = Q.dequantize(pool[ph], scales[ph][:, None, :, None])
            page = torch.where(onehot, tok.float()[:, None], page)
            scale = Q.compute_scale(page, (1, 3), kv_dt, where=vmask)
            _scatter_rows(pool, phys, ok,
                          Q.quantize(page, scale[:, None, :, None], kv_dt))
            _scatter_rows(scales, phys, ok, scale)

        requant(pk, cache["scales_k"], tok_k)
        requant(pv, cache["scales_v"], tok_v)
    else:
        slot = phys * ps + off
        _scatter_rows(pk.view(num_pages * ps, hkv, dh), slot, ok, tok_k)
        _scatter_rows(pv.view(num_pages * ps, hkv, dh), slot, ok, tok_v)
    if "centroids" in cache:
        cents = cache["centroids"]                           # (P,hkv,dh) f32
        m = off.float()[:, None, None]                       # tokens in page
        old = cents[phys.clamp(min=0).long()]                # (B,hkv,dh)
        upd = (old * m + tok_k.float()) / (m + 1.0)
        _scatter_rows(cents, phys, ok, upd)
    return cache


def paged_append_prefill(cache: Dict, block_table: torch.Tensor,
                         q_len: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor,
                         kv_len: Optional[torch.Tensor] = None) -> Dict:
    """Scatter a right-padded ragged prompt chunk into its pages, in
    place.

    k_new/v_new: (B, hkv, L, dh); row i's valid tokens occupy absolute
    positions [kv_len[i], kv_len[i] + q_len[i]).  ``kv_len`` of None (or
    zeros) is a fresh one-shot prefill; non-zero offsets are chunked
    prefill continuations writing into a partially-filled tail page.
    Every page the chunk touches gets its centroid recomputed from the
    stored keys, so the result is identical to a one-shot prefill of the
    whole prefix.

    Quantized pools stage the touched pages in fp32 — prior pool tokens
    dequantized, the incoming chunk scattered over them — then
    requantize each touched page whole (amax over its valid tokens) and
    scatter payload and scales back.  Centroids come from the staging
    view with the masked reduce of the fp32 path, so a page wholly
    written by this call (every page of a one-shot prefill) gets the
    fp32 pool's centroid byte for byte.
    """
    pk, pv = cache["pages_k"], cache["pages_v"]
    num_pages, ps, hkv, dh = pk.shape
    b, _, length, _ = k_new.shape
    npg = block_table.shape[1]
    dev = pk.device
    if kv_len is None:
        kv_len = torch.zeros((b,), dtype=torch.int32, device=dev)
    pos = kv_len[:, None] + torch.arange(length, device=dev)  # (B,L) abs pos
    logical = torch.clamp(pos // ps, max=npg - 1)
    phys = block_table.gather(1, logical.long())              # (B,L)
    valid = ((torch.arange(length, device=dev)[None, :] < q_len[:, None])
             & (phys >= 0))
    vals_k = k_new.permute(0, 2, 1, 3).reshape(b * length, hkv, dh)
    vals_v = v_new.permute(0, 2, 1, 3).reshape(b * length, hkv, dh)
    post = q_len + kv_len                                    # (B,)
    page_start = torch.arange(npg, device=dev) * ps
    cnt = torch.clamp(post[:, None] - page_start, 0, ps)
    touched = ((cnt > 0) & (block_table >= 0)
               & (page_start + ps > kv_len[:, None]))        # (B,npg)
    wmask = (torch.arange(ps, device=dev)[None, None, :]
             < cnt[..., None])[..., None, None]              # (B,npg,ps,1,1)
    tbl = block_table.clamp(min=0).long()
    if "scales_k" in cache:
        kv_dt = Q.kv_dtype_of(pk.dtype)
        stage_slot = ((torch.arange(b, device=dev)[:, None] * npg + logical)
                      * ps + pos % ps).reshape(-1)

        def stage_and_quant(pool, scales, vals):
            stage = Q.dequantize(pool[tbl], scales[tbl][:, :, None, :, None])
            _scatter_rows(stage.view(b * npg * ps, hkv, dh), stage_slot,
                          valid, vals.float())
            scale = Q.compute_scale(stage, (2, 4), kv_dt, where=wmask)
            payload = Q.quantize(stage, scale[:, :, None, :, None], kv_dt)
            _scatter_rows(pool, block_table.reshape(-1), touched,
                          payload.reshape(b * npg, ps, hkv, dh))
            _scatter_rows(scales, block_table.reshape(-1), touched,
                          scale.reshape(b * npg, hkv))
            return stage

        cent_src = stage_and_quant(pk, cache["scales_k"], vals_k)
        stage_and_quant(pv, cache["scales_v"], vals_v)
    else:
        slot = (phys * ps + pos % ps).reshape(-1)
        _scatter_rows(pk.view(num_pages * ps, hkv, dh), slot, valid, vals_k)
        _scatter_rows(pv.view(num_pages * ps, hkv, dh), slot, valid, vals_v)
        cent_src = pk[tbl] if "centroids" in cache else None
    if "centroids" in cache:
        sums = (cent_src.float() * wmask).sum(dim=2)         # (B,npg,h,d)
        cent = sums / torch.clamp(cnt, min=1)[..., None, None].float()
        _scatter_rows(cache["centroids"], block_table.reshape(-1), touched,
                      cent.reshape(b * npg, hkv, dh))
    return cache


def paged_gather_kv(cache: Dict, block_table: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densify: (B, hkv, npg*ps, dh) K and V in logical token order.

    Positions past a sequence's length (and pages it never allocated)
    hold whatever the pool contains — callers mask with ``kv_len``.
    Quantized pools come back dequantized to fp32.
    """
    pk, pv = cache["pages_k"], cache["pages_v"]
    _, ps, hkv, dh = pk.shape
    b, npg = block_table.shape
    tbl = block_table.clamp(min=0).long()

    def densify(pool, scales):
        g = pool[tbl]                                        # (B,npg,ps,h,d)
        if scales is not None:
            g = Q.dequantize(g, scales[tbl][:, :, None, :, None])
        return g.permute(0, 3, 1, 2, 4).reshape(b, hkv, npg * ps, dh)

    return (densify(pk, cache.get("scales_k")),
            densify(pv, cache.get("scales_v")))


def swa_windowed_decode_attention(q: torch.Tensor, cache: Dict,
                                  block_table: torch.Tensor,
                                  kv_len: torch.Tensor, window: int,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Decode-step sliding-window attention that gathers only the
    ``ceil(window/page_size)+1`` pages that can intersect the window.

    q (B, H, 1, d); ``kv_len`` post-append lengths, so the query sits at
    position ``kv_len - 1`` and attends keys in ``(qpos-window, qpos]``.
    Rows with ``kv_len`` 0 return zeros.  Quantized pools are
    dequantized on the gathered pages.
    """
    from repro_torch.core.attention import (NEG_INF, _apply_and_project,
                                            _grouped_scores)

    pk, pv = cache["pages_k"], cache["pages_v"]
    _, ps, hkv, dh = pk.shape
    b, npg = block_table.shape
    dev = q.device
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    wpg = min(npg, -(-window // ps) + 1)
    qpos = kv_len - 1                                        # (B,)
    start = torch.clamp(qpos - window + 1, min=0) // ps      # first page
    logical = start[:, None] + torch.arange(wpg, device=dev)[None, :]
    phys = block_table.gather(1, torch.clamp(logical, max=npg - 1).long())
    ok = (logical < npg) & (phys >= 0)                       # (B,wpg)
    tbl = phys.clamp(min=0).long()
    kg, vg = pk[tbl], pv[tbl]                                # (B,wpg,ps,h,d)
    if "scales_k" in cache:
        kg = Q.dequantize(kg, cache["scales_k"][tbl][:, :, None, :, None])
        vg = Q.dequantize(vg, cache["scales_v"][tbl][:, :, None, :, None])
    kg = kg.permute(0, 3, 1, 2, 4).reshape(b, hkv, wpg * ps, dh)
    vg = vg.permute(0, 3, 1, 2, 4).reshape(b, hkv, wpg * ps, dh)
    kpos = (logical[:, :, None] * ps
            + torch.arange(ps, device=dev)[None, None, :]).reshape(b, -1)
    mask = (torch.repeat_interleave(ok, ps, dim=1)
            & (kpos <= qpos[:, None])
            & (qpos[:, None] - kpos < window))               # (B,wpg*ps)
    s = _grouped_scores(q, kg, scale)                        # (B,H,1,n)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, None], p, 0.0)
    return _apply_and_project(p, vg, q.dtype)


# --------------------------------------------------------------------------
# page-granular cache ops (prefix cache / COW / swap preemption).
#
# ``caches`` here is the engine-level dict ``{"slot_i": pool}`` whose
# leaves carry a leading layer-group dim (G, ...).  These run between the
# scheduler's plan and the step's first write, in place.  Page and slot
# ids are host ints, so the copies are plain slices: no index upload, no
# host sync.
# --------------------------------------------------------------------------

def copy_pages(caches, src: List[int], dst: List[int]):
    """Copy-on-write: duplicate physical pages ``src[i] -> dst[i]`` in
    every page-indexed leaf (K/V, scales, centroids, key-conv tails), so
    a sequence diverging mid-page writes into its own copy.  Copying the
    centroid too keeps the page routable; the suffix prefill recomputes
    it from the stored keys once it appends."""
    for s, d in zip(src, dst):
        for pool in caches.values():
            for name in PAGE_LEAVES:
                if name in pool:
                    pool[name][:, d].copy_(pool[name][:, s])
    return caches


def load_ring_from_tails(caches, slots: List[int], pages: List[int]):
    """Prefix-hit admission for key-conv models: sequence ``slots[i]``'s
    ring row becomes page ``pages[i]``'s raw-key tail, the last
    ``width - 1`` raw keys before the match boundary: the state a
    contiguous prefill would have carried into the suffix."""
    for sl, pg in zip(slots, pages):
        for pool in caches.values():
            if "key_conv_tails" in pool and "key_conv_state" in pool:
                pool["key_conv_state"][:, sl].copy_(
                    pool["key_conv_tails"][:, pg])
    return caches


def gather_pages_host(caches, pages: List[int]) -> Dict:
    """Snapshot physical pages to host memory (swap-out): every
    page-indexed leaf sliced at ``pages``, keyed (slot_name, leaf), as
    CPU tensors (numpy has no bf16)."""
    out = {}
    for sname, pool in caches.items():
        idx = torch.as_tensor(pages, dtype=torch.long,
                              device=pool["pages_k"].device)
        for name in PAGE_LEAVES:
            if name in pool:
                out[(sname, name)] = pool[name][:, idx].cpu()
    return out


def scatter_pages_device(caches, pages: List[int], data: Dict):
    """Swap-in: write a :func:`gather_pages_host` snapshot into the
    (freshly reserved) physical pages ``pages``, in place."""
    for sname, pool in caches.items():
        idx = torch.as_tensor(pages, dtype=torch.long,
                              device=pool["pages_k"].device)
        for name in PAGE_LEAVES:
            if name in pool:
                x = pool[name]
                x[:, idx] = data[(sname, name)].to(x.device, x.dtype)
    return caches


def gather_ring_rows(caches, slot: int) -> Dict:
    """Host snapshot of one sequence slot's key-conv ring row in every
    group, keyed (slot_name, leaf); empty for pools without a ring."""
    return {(sname, "key_conv_state"): pool["key_conv_state"][:, slot].cpu()
            for sname, pool in caches.items() if "key_conv_state" in pool}


def scatter_ring_rows(caches, slot: int, data: Dict):
    """Write a :func:`gather_ring_rows` snapshot into sequence slot
    ``slot``'s ring row, in place."""
    for sname, pool in caches.items():
        if "key_conv_state" in pool:
            x = pool["key_conv_state"]
            x[:, slot] = data[(sname, "key_conv_state")].to(x.device, x.dtype)
    return caches
