"""MoBA routing: block centroids, causal top-k selection, varlen layout.

Shapes convention (single batch*head slice unless noted):
  q:      (N, d)     queries
  k:      (N, d)     keys
  n_blocks = ceil(N / B)

Selection semantics (faithful to the paper / Lu et al.):
  * score of block j for query t is  s_j = q_t · k̃_j  (no 1/sqrt(d))
  * blocks strictly in the future of t are masked out
  * the query's own block is always selected and counts toward top-k
  * early queries with fewer than k valid blocks select all valid ones;
    the empty slots carry the sentinel block id ``n_blocks``.

Top-k order is ``lax.top_k``'s, as in the reference: score descending
on the float's total order (+0.0 above -0.0), then the lower block id.
:func:`order_key` defines it once; :func:`topk_desc` sorts on it stably
instead of calling ``torch.topk``, which promises no order among equal
scores and ties the two zeros.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30
POS_INF = 1e30


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is the float32 total order of ``x``
    (``i ^ ((i >> 31) & 0x7fffffff)`` of its bits): -0.0 sorts below
    +0.0, every other pair as the floats compare.  The CUDA kernels'
    rank merges compare the same keys (``order_key`` in
    ``kernels/csrc/moba_decode.cu`` and ``flash_topk.cu``)."""
    i = x.float().contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def topk_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of the last axis in ``lax.top_k``'s order: descending on
    :func:`order_key`, ties to the lower index."""
    idx = torch.sort(order_key(x), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def pad_to_blocks(x: torch.Tensor, block_size: int,
                  axis: int = 0) -> torch.Tensor:
    n = x.shape[axis]
    rem = (-n) % block_size
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def block_centroids(k: torch.Tensor, block_size: int,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-pool keys into block centroids.

    k: (..., N, d) -> (..., n_blocks, d).  If ``kv_len`` is given (decode
    with a partially-filled cache) positions >= kv_len are excluded from
    the mean.
    """
    *lead, n, d = k.shape
    kp = pad_to_blocks(k, block_size, axis=-2)
    nb = kp.shape[-2] // block_size
    kb = kp.reshape(*lead, nb, block_size, d).float()
    blk = torch.arange(nb, device=k.device)
    pos = blk[:, None] * block_size + torch.arange(block_size,
                                                   device=k.device)[None]
    if kv_len is None:
        denom = torch.clamp(n - blk * block_size, 1, block_size).float()
        valid = pos < n
    else:
        valid = pos < kv_len
        denom = torch.clamp(valid.sum(-1), min=1).float()
    out = (kb * valid[..., None]).sum(-2) / denom[..., None]
    return out.to(k.dtype)


def routing_scores(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """q: (..., Nq, d), centroids: (..., nb, d) -> scores (..., Nq, nb)."""
    return torch.einsum("...qd,...bd->...qb", q.float(), centroids.float())


def select_blocks(scores: torch.Tensor, top_k: int, block_size: int,
                  q_positions: torch.Tensor, causal: bool = True,
                  head_top_k: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Top-k block selection with causal masking + forced current block.

    scores: (..., Nq, nb); q_positions: (Nq,) absolute token positions.
    Returns int32 (..., Nq, k) of selected block ids, sentinel ``nb`` for
    empty slots.  The current block (if causal) is forced via +inf so it
    always occupies a slot — faithful to MoBA's accounting.

    ``head_top_k`` (optional int32, broadcastable against the leading
    dims of ``scores``, values in [1, top_k]) truncates each head's
    selection to its own budget: slots ranked >= head_top_k become
    sentinels.  The slots are score-sorted with the own block first, so
    keeping the first ``head_top_k`` is per-head top-k at static shapes.
    """
    nb = scores.shape[-1]
    own = q_positions // block_size                          # (Nq,)
    blk = torch.arange(nb, device=scores.device)
    if causal:
        future = blk[None, :] > own[:, None]                 # (Nq, nb)
        is_own = blk[None, :] == own[:, None]
        masked = torch.where(future, NEG_INF, scores)
        masked = torch.where(is_own, POS_INF, masked)
    else:
        masked = scores
    kk = min(top_k, nb)
    top_scores, top_idx = topk_desc(masked, kk)
    # slots whose score is NEG_INF are invalid -> sentinel
    top_idx = torch.where(top_scores <= NEG_INF / 2, nb, top_idx)
    if kk < top_k:  # fewer blocks than k: pad with sentinels
        pad = torch.full(top_idx.shape[:-1] + (top_k - kk,), nb,
                         dtype=top_idx.dtype, device=top_idx.device)
        top_idx = torch.cat([top_idx, pad], dim=-1)
    if head_top_k is not None:
        keep = (torch.arange(top_k, device=top_idx.device)
                < head_top_k[..., None, None])
        top_idx = torch.where(keep, top_idx, nb)
    return top_idx.to(torch.int32)


def selection_mask(top_idx: torch.Tensor, nb: int) -> torch.Tensor:
    """(..., Nq, k) block ids -> boolean (..., Nq, nb) selection mask."""
    mask = torch.zeros(top_idx.shape[:-1] + (nb + 1,), dtype=torch.bool,
                       device=top_idx.device)
    mask.scatter_(-1, top_idx.long(), True)     # sentinel lands in column nb
    return mask[..., :nb]


class VarlenLayout(NamedTuple):
    """Key-block-major padded varlen layout (paper Alg. 4), batched over a
    leading (B·H) dim.

    With Nq queries each selecting k blocks there are exactly Nq*k
    (query, block) pairs.  Pairs are sorted by block id (stable, so query
    order is kept inside a block), then each block's run is padded to a
    multiple of the tile Tq so every tile maps to exactly one key block.
    Capacity L = Nq*k + nb*Tq bounds any padding outcome; sentinel pairs
    are parked in the trailing region.  All int32.
    """

    q_index: torch.Tensor     # (BH, L) query position per slot, -1 = pad
    slot_block: torch.Tensor  # (BH, L) block id per slot, nb = pad
    tile_block: torch.Tensor  # (BH, L/Tq) block id per tile, nb = inactive
    pair_slot: torch.Tensor   # (BH, Nq, k) slot index of each pair


def layout_capacity(nq: int, k: int, nb: int, tile: int) -> int:
    return nq * k + nb * tile


def build_varlen_layout(top_idx: torch.Tensor, nq: int, nb: int,
                        tile: int) -> VarlenLayout:
    """top_idx: (BH, Nq, k) selected block ids (sentinel nb).  The
    reference's per-head construction with (B·H) as a leading dim; counts
    come from ``scatter_add_`` (no host sync), so the shapes stay static
    and the card never waits on the host."""
    bh, _, k = top_idx.shape
    dev = top_idx.device
    flat_block = top_idx.reshape(bh, nq * k).long()           # (BH, P)
    flat_q = torch.arange(nq, device=dev).repeat_interleave(k)

    sb, order = torch.sort(flat_block, dim=-1, stable=True)
    sq = flat_q[order]

    counts = torch.zeros((bh, nb + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_block, torch.ones_like(flat_block))
    padded = (counts + tile - 1) // tile * tile
    zero = counts.new_zeros((bh, 1))
    # sentinel pairs live in the trailing region: they take whatever
    # space remains, so slot indices stay in bounds
    starts = torch.cat([zero, torch.cumsum(padded[:, :-1], dim=1)], dim=1)
    offsets = torch.cat([zero, torch.cumsum(counts[:, :-1], dim=1)], dim=1)

    capacity = layout_capacity(nq, k, nb, tile)
    rank = (torch.arange(nq * k, device=dev)[None]
            - offsets.gather(1, sb))
    slot = starts.gather(1, sb) + rank                        # (BH, P)

    q_index = torch.full((bh, capacity), -1, dtype=torch.long, device=dev)
    q_index.scatter_(1, slot, torch.where(sb == nb, -1, sq))
    slot_block = torch.full((bh, capacity), nb, dtype=torch.long,
                            device=dev)
    slot_block.scatter_(1, slot, sb)
    # every tile of an active run starts with a real slot (padding sits at
    # the run's tail), so the first slot names the tile's block
    first = slot_block.reshape(bh, -1, tile)[:, :, 0]
    tile_block = torch.where(first < nb, first, nb)
    pair_slot = torch.zeros((bh, nq * k), dtype=torch.long, device=dev)
    pair_slot.scatter_(1, order, slot)
    return VarlenLayout(q_index.to(torch.int32),
                        slot_block.to(torch.int32),
                        tile_block.to(torch.int32),
                        pair_slot.reshape(bh, nq, k).to(torch.int32))
