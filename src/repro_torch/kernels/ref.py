"""Plain PyTorch versions of the FlashMoBA training kernels, plus the
``xla`` backend's differentiable gather-and-densify path.

Counterpart of the reference's ``kernels/ref.py``.  Every function here
is batched over a leading (B·H) dim — the reference vmaps single heads —
and maps a query row ``bh`` to its key/value row with the GQA kv-row map
:func:`kv_rows`.  Each is the function its CUDA kernel computes, in fp32,
and is what a CPU tensor gets from the kernel's wrapper; ``chip_smoke.py``
holds every kernel against it on the card.

The per-tile work runs over chunks of tiles, so the plain versions fit
on the card at the main path's shapes (one (B·H, chunk, tile, block)
score tensor at a time).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MoBAConfig
from repro_torch.core import routing

NEG_INF = routing.NEG_INF
# tiles per step of the plain kernels' loops: one (B·H, 64, tile, block)
# fp32 score tensor is ~67 MB at moba-340m's shapes
_TILE_CHUNK = 64


def kv_rows(bh: int, num_q_heads: int, group: int,
            device=None) -> torch.Tensor:
    """(B·H,) int64 key/value row of every query row:
    ``(bh // H)·Hkv + (bh % H) // G``."""
    r = torch.arange(bh, device=device)
    return (r // num_q_heads) * (num_q_heads // group) \
        + (r % num_q_heads) // group


def empty_as(t: torch.Tensor, width: int) -> torch.Tensor:
    """An empty tensor like ``t`` but ``width`` wide in its last dim:
    ``torch.empty_like`` where the widths agree (the same operations as
    always), a new shape only where they differ (latent attention's
    dV)."""
    if t.shape[-1] == width:
        return torch.empty_like(t)
    return t.new_empty(t.shape[:-1] + (width,))


# ---------------------------------------------------------------- centroids
def centroids_ref(k: torch.Tensor, block_size: int) -> torch.Tensor:
    """k: (BKV, N, d) -> (BKV, nb, d) in k.dtype; the ragged tail block is
    averaged over its valid rows only."""
    return routing.block_centroids(k, block_size)


# ---------------------------------------------------------------- flash topk
def flash_topk_ref(q: torch.Tensor, centroids: torch.Tensor, top_k: int,
                   block_size: int, *, group: int = 1, num_q_heads: int = 0,
                   causal: bool = True, q_pos_offset: int = 0
                   ) -> torch.Tensor:
    """q: (BH, Nq, d), centroids: (BKV, nb, d) -> (BH, Nq, top_k) int32
    selected block ids (sentinel nb).  Materialises the (Nq, nb) score
    matrix — exactly what the kernel avoids."""
    bh, nq, _ = q.shape
    h = num_q_heads or bh
    kv = kv_rows(bh, h, group, q.device)
    scores = routing.routing_scores(q, centroids[kv])        # (BH, Nq, nb)
    pos = torch.arange(nq, device=q.device) + q_pos_offset
    return routing.select_blocks(scores, top_k, block_size, pos,
                                 causal=causal)


def flash_topk_merge_ref(q: torch.Tensor, centroids: torch.Tensor,
                         top_k: int, block_size: int, *, group: int = 1,
                         num_q_heads: int = 0, causal: bool = True,
                         q_pos_offset: int = 0) -> torch.Tensor:
    """The CUDA kernel's selection arithmetic in PyTorch, for every row at
    once: candidates offered in the kernel's order (ascending block id,
    only blocks up to the own one when causal, the own one at +1e30); a
    candidate not strictly above the row's k-th score is filtered out; a
    survivor is merged by rank — its place is the number of list entries
    that beat it (strictly higher score on ``routing.order_key``'s total
    order: every entry has a lower id), and
    each entry it beats moves down one place.  Empty slots hold -3e30;
    slots at or below -5e29 end as the sentinel nb.  Same arguments and
    result as :func:`flash_topk_ref`."""
    bh, nq, _ = q.shape
    nb = centroids.shape[1]
    h = num_q_heads or bh
    kv = kv_rows(bh, h, group, q.device)
    scores = routing.routing_scores(q, centroids[kv])        # (BH, Nq, nb)
    own = (torch.arange(nq, device=q.device) + q_pos_offset) // block_size
    ls = torch.full((bh, nq, top_k), -3e30, device=q.device)
    li = torch.zeros((bh, nq, top_k), dtype=torch.int64, device=q.device)
    for c in range(nb):
        x = scores[..., c:c + 1]
        if causal:
            x = torch.where((own == c)[:, None], routing.POS_INF, x)
        offered = (own >= c) if causal else torch.ones_like(own, dtype=bool)
        beats = (routing.order_key(x) > routing.order_key(ls)) \
            & offered[:, None]
        above = torch.cat([torch.zeros_like(beats[..., :1]),
                           beats[..., :-1]], dim=-1)          # beats j - 1
        ls = torch.where(beats, torch.where(above, torch.cat(
            [ls[..., :1], ls[..., :-1]], -1), x), ls)
        li = torch.where(beats, torch.where(above, torch.cat(
            [li[..., :1], li[..., :-1]], -1), c), li)
    return torch.where(ls <= NEG_INF / 2, nb, li).to(torch.int32)


# ------------------------------------------------------------- fwd partials
class MobaPartials(NamedTuple):
    o: torch.Tensor   # (BH, L, dv) fp32 un-normalised partial outputs
    m: torch.Tensor   # (BH, L) fp32 row max (NEG_INF for masked slots)
    l: torch.Tensor   # (BH, L) fp32 sum of exp


def _tile_mask(qp: torch.Tensor, blk: torch.Tensor, block_size: int,
               nb: int, n_tokens: int, causal: bool) -> torch.Tensor:
    """qp (..., tq) slot positions, blk (..., tq or 1) block ids ->
    (..., tq, bs) mask: ``q_pos >= 0``, a real block, ``kpos < n_tokens``
    and (causal) ``kpos <= q_pos``."""
    kpos = (blk[..., None] * block_size
            + torch.arange(block_size, device=qp.device))
    mask = (qp[..., None] >= 0) & (blk[..., None] < nb) & (kpos < n_tokens)
    if causal:
        mask &= kpos <= qp[..., None]
    return mask


def _softmax_partials(s: torch.Tensor, mask: torch.Tensor, vt: torch.Tensor,
                      pv_dtype=None):
    """Masked per-row (o, m, l) of scores s (..., tq, bs) against
    vt (..., bs, d).  ``pv_dtype`` rounds p before the PV product (the
    reference's ``xla`` path feeds p to the MXU in v's dtype)."""
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None]) * mask
    l = p.sum(dim=-1)
    if pv_dtype is not None:
        p = p.to(pv_dtype).float()
    o = torch.matmul(p, vt)
    m = torch.where(mask.any(dim=-1), m, NEG_INF)
    return o, m, l


def _tile_operands(tile_block, q_sorted, q_pos, k_blocks, v_blocks, kv,
                   t0: int, t1: int):
    """Tiles [t0, t1) of the sorted layout: their block ids (BH, Tc), q
    (BH, Tc, tq, d) fp32, q_pos (BH, Tc, tq), and the K/V of each tile's
    block (BH, Tc, bs, d / dv) fp32."""
    bh, ln, d = q_sorted.shape
    nb = k_blocks.shape[1]
    tq = ln // tile_block.shape[1]
    tb = tile_block[:, t0:t1].long()
    blk = tb.clamp(max=nb - 1)
    kt = k_blocks[kv[:, None], blk].float()
    vt = v_blocks[kv[:, None], blk].float()
    qt = q_sorted[:, t0 * tq:t1 * tq].reshape(bh, t1 - t0, tq, d).float()
    qp = q_pos[:, t0 * tq:t1 * tq].reshape(bh, t1 - t0, tq).long()
    return tb, qt, qp, kt, vt


def moba_partials_ref(tile_block: torch.Tensor, q_sorted: torch.Tensor,
                      q_pos: torch.Tensor, k_blocks: torch.Tensor,
                      v_blocks: torch.Tensor, *, scale: float,
                      block_size: int, n_tokens: int, num_q_heads: int,
                      group: int, causal: bool = True) -> MobaPartials:
    """Plain version of the forward kernel, full fp32.

    tile_block (BH, T) int32; q_sorted (BH, L, d); q_pos (BH, L) int32
    (-1 = pad); k_blocks (BKV, nb, bs, d), v_blocks (BKV, nb, bs, dv).
    Each tile attends to its one key block."""
    bh, ln, _ = q_sorted.shape
    nb, dv = k_blocks.shape[1], v_blocks.shape[-1]
    n_tiles = tile_block.shape[1]
    kv = kv_rows(bh, num_q_heads, group, q_sorted.device)
    o = torch.empty((bh, ln, dv), dtype=torch.float32,
                    device=q_sorted.device)
    m = torch.empty((bh, ln), dtype=torch.float32, device=q_sorted.device)
    l = torch.empty_like(m)
    tq = ln // n_tiles
    for t0 in range(0, n_tiles, _TILE_CHUNK):
        t1 = min(t0 + _TILE_CHUNK, n_tiles)
        tb, qt, qp, kt, vt = _tile_operands(tile_block, q_sorted, q_pos,
                                            k_blocks, v_blocks, kv, t0, t1)
        s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
        mask = _tile_mask(qp, tb[..., None], block_size, nb, n_tokens,
                          causal)
        oc, mc, lc = _softmax_partials(s, mask, vt)
        o[:, t0 * tq:t1 * tq] = oc.reshape(bh, -1, dv)
        m[:, t0 * tq:t1 * tq] = mc.reshape(bh, -1)
        l[:, t0 * tq:t1 * tq] = lc.reshape(bh, -1)
    return MobaPartials(o, m, l)


def merge_partials(o_parts: torch.Tensor, m_parts: torch.Tensor,
                   l_parts: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-style lse merge over axis -2 (the per-query ``k`` partials).

    o_parts (..., k, d); m/l (..., k) -> (out (..., d), lse (...,))."""
    m_max = m_parts.amax(dim=-1)
    m_safe = torch.clamp(m_max, min=NEG_INF / 2)
    w = torch.exp(m_parts - m_safe[..., None])
    l_tot = (l_parts * w).sum(dim=-1)
    o = (o_parts * w[..., None]).sum(dim=-2)
    l_tot = torch.clamp(l_tot, min=1e-30)
    return o / l_tot[..., None], m_safe + torch.log(l_tot)


# --------------------------------------------------------------------- bwd
class MobaGrads(NamedTuple):
    dq_sorted: torch.Tensor  # (BH, L, d) fp32
    dk_blocks: torch.Tensor  # (BH, nb, bs, d) fp32, per query head
    dv_blocks: torch.Tensor  # (BH, nb, bs, dv) fp32, per query head


def moba_bwd_ref(tile_block: torch.Tensor, q_sorted: torch.Tensor,
                 q_pos: torch.Tensor, do_sorted: torch.Tensor,
                 lse_sorted: torch.Tensor, delta_sorted: torch.Tensor,
                 k_blocks: torch.Tensor, v_blocks: torch.Tensor, *,
                 scale: float, block_size: int, n_tokens: int,
                 num_q_heads: int, group: int,
                 causal: bool = True) -> MobaGrads:
    """Plain version of the backward kernel: recompute p = exp(s - lse),
    then per-slot dQ and per-block dK/dV (segment sums over each block's
    tiles; unvisited blocks are zero).

    lse_sorted / delta_sorted: per-slot final logsumexp and
    rowsum(dO ∘ O) of the slot's query.  do_sorted and v_blocks are dv
    wide, q_sorted and k_blocks d."""
    bh, ln, d = q_sorted.shape
    nb, dvw = k_blocks.shape[1], v_blocks.shape[-1]
    bs = block_size
    n_tiles = tile_block.shape[1]
    tq = ln // n_tiles
    dev = q_sorted.device
    kv = kv_rows(bh, num_q_heads, group, dev)
    dq = torch.empty((bh, ln, d), dtype=torch.float32, device=dev)
    # segment nb of each row collects the inactive tiles and is dropped
    dk = torch.zeros((bh * (nb + 1), bs, d), dtype=torch.float32, device=dev)
    dv = empty_as(dk, dvw).zero_()
    row0 = torch.arange(bh, device=dev)[:, None] * (nb + 1)
    for t0 in range(0, n_tiles, _TILE_CHUNK):
        t1 = min(t0 + _TILE_CHUNK, n_tiles)
        tb, qt, qp, kt, vt = _tile_operands(tile_block, q_sorted, q_pos,
                                            k_blocks, v_blocks, kv, t0, t1)
        sl = slice(t0 * tq, t1 * tq)
        dot = do_sorted[:, sl].reshape(bh, t1 - t0, tq, dvw).float()
        lse = lse_sorted[:, sl].reshape(bh, t1 - t0, tq, 1)
        delta = delta_sorted[:, sl].reshape(bh, t1 - t0, tq, 1)
        mask = _tile_mask(qp, tb[..., None], bs, nb, n_tokens, causal)
        s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dp = torch.matmul(dot, vt.transpose(-1, -2))
        ds = p * (dp - delta) * scale
        dq[:, sl] = torch.matmul(ds, kt).reshape(bh, -1, d)
        seg = (row0 + tb.clamp(max=nb)).reshape(-1)
        dk.index_add_(0, seg, torch.matmul(ds.transpose(-1, -2), qt)
                      .reshape(-1, bs, d))
        dv.index_add_(0, seg, torch.matmul(p.transpose(-1, -2), dot)
                      .reshape(-1, bs, dvw))
    dk = dk.reshape(bh, nb + 1, bs, d)[:, :nb]
    dv = dv.reshape(bh, nb + 1, bs, dvw)[:, :nb]
    return MobaGrads(dq, dk, dv)


# ------------------------------------------------- the xla backend's path
def moba_sparse_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: MoBAConfig,
                    q_positions: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, tile: int = 128,
                    tile_chunk: int = 8) -> torch.Tensor:
    """Gather-and-densify MoBA in plain PyTorch with the kernels' varlen
    layout and tiling — O(N·k·B) work, memory bounded by a loop over
    chunks of ``tile_chunk`` tiles (the reference's ``lax.scan``).
    Differentiable through torch autograd; routing is not.

    q (B, H, Nq, d); k, v (B, Hkv, N, d)."""
    from repro_torch.core.moba import moba_selection

    b, h, nq, d = q.shape
    _, hkv, n, _ = k.shape
    g = h // hkv
    bs, tk = cfg.block_size, cfg.top_k
    nb = -(-n // bs)
    dev = q.device
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_positions is None:
        q_positions = torch.arange(nq, device=dev) + (n - nq)
    tile = min(tile, nq)

    with torch.no_grad():
        sel = moba_selection(q, k, cfg, q_positions)          # (B,H,Nq,k)
        lay = routing.build_varlen_layout(sel.reshape(b * h, nq, tk), nq,
                                          nb, tile)
    kb = routing.pad_to_blocks(k, bs, axis=-2).reshape(b * hkv, nb, bs, d)
    vb = routing.pad_to_blocks(v, bs, axis=-2).reshape(b * hkv, nb, bs, d)
    kv = kv_rows(b * h, h, g, dev)
    rows = torch.arange(b * h, device=dev)[:, None]
    qi = lay.q_index.long().clamp(min=0)
    q_sorted = q.reshape(b * h, nq, d)[rows, qi]              # (BH, L, d)
    q_pos = torch.where(lay.q_index >= 0, q_positions.long()[qi], -1)
    n_tiles = q_sorted.shape[1] // tile

    outs = []
    for t0 in range(0, n_tiles, tile_chunk):
        t1 = min(t0 + tile_chunk, n_tiles)
        sl = slice(t0 * tile, t1 * tile)
        blk = lay.tile_block[:, t0:t1].long().clamp(max=nb - 1)
        kt = kb[kv[:, None], blk].float()                     # (BH,Tc,bs,d)
        vt = vb[kv[:, None], blk]
        qt = q_sorted[:, sl].reshape(b * h, t1 - t0, tile, d).float()
        qp = q_pos[:, sl].reshape(b * h, t1 - t0, tile)
        sb = lay.slot_block[:, sl].reshape(b * h, t1 - t0, tile).long()
        s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
        mask = _tile_mask(qp, sb, bs, nb, n, cfg.causal)
        outs.append(_softmax_partials(s, mask, vt.float(),
                                      pv_dtype=vt.dtype))
    o_l = torch.cat([o.reshape(b * h, -1, d) for o, _, _ in outs], dim=1)
    m_l = torch.cat([m.reshape(b * h, -1) for _, m, _ in outs], dim=1)
    l_l = torch.cat([l.reshape(b * h, -1) for _, _, l in outs], dim=1)
    slots = lay.pair_slot.reshape(b * h, nq * tk).long()
    out, _ = merge_partials(o_l[rows, slots].reshape(b * h, nq, tk, d),
                            m_l.gather(1, slots).reshape(b * h, nq, tk),
                            l_l.gather(1, slots).reshape(b * h, nq, tk))
    return out.reshape(b, h, nq, d).to(q.dtype)
