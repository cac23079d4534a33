"""FlashMoBA: the training attention of the ``flash`` backend, as a
``torch.autograd.Function`` over the four Hopper kernels.

Counterpart of the reference's ``kernels/ops.py::flash_moba``:

  fwd:  key-block centroids (kernel) → Flash TopK (kernel) → varlen layout
        (stable sort + cumsum, ``core/routing.py``) → Q gather → forward
        kernel → per-query lse merge of the k partials
  bwd:  delta = rowsum(dO ∘ O) → gather to the sorted layout → backward
        kernel (recompute) → segment-sum dQ, group-reduce dK/dV

q and k may be wider than v (latent attention: q/k 192, v 128); the
output and dO take v's width, dQ and dK q's.

Ragged query lengths (Nq not a multiple of the q tile) are padded to the
tile inside the pipeline: padded rows route to the sentinel block, so
their layout slots carry ``q_pos = -1``, which the kernels mask, and the
pad is sliced off again before returning.

Routing is not differentiated (hard top-k, as in MoBA training): the
backward returns gradients for q, k, v only.  On CPU tensors every
kernel wrapper takes its plain version, so the same Function runs there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import MoBAConfig
from repro_torch.core import routing
from repro_torch.kernels.centroids import block_centroids_kernel
from repro_torch.kernels.flash_topk import flash_topk
from repro_torch.kernels.moba_bwd import moba_bwd
from repro_torch.kernels.moba_fwd import moba_fwd
from repro_torch.kernels.ref import merge_partials


class _Meta(NamedTuple):
    block_size: int
    top_k: int
    causal: bool
    q_tile: int
    scale: float
    kb_tile: int = 0
    grid: str = "grouped"


def flatten_kv_blocks(k: torch.Tensor, block_size: int):
    b, hkv, n, d = k.shape
    nb = -(-n // block_size)
    kp = routing.pad_to_blocks(k, block_size, axis=-2)
    return kp.reshape(b * hkv, nb, block_size, d), nb


def padded_queries(q: torch.Tensor, tile: int) -> torch.Tensor:
    """q (B, H, Nq, d) -> (B·H, Nq_p, d), zero rows up to a multiple of
    the q tile."""
    b, h, nq, d = q.shape
    qf = q.reshape(b * h, nq, d)
    nq_p = -(-nq // tile) * tile
    if nq_p == nq:
        return qf
    return torch.cat([qf, qf.new_zeros((b * h, nq_p - nq, d))], dim=1)


def sorted_layout(qf: torch.Tensor, sel: torch.Tensor, nq: int, nb: int,
                  tile: int, q_pos_offset: int):
    """The key-block-major layout of selections ``sel`` (B·H, Nq_p, k)
    over padded queries ``qf`` (B·H, Nq_p, d): (layout, q_sorted (B·H, L,
    d), q_pos (B·H, L) int32).  Pad queries (rows >= nq) route to the
    sentinel block, so their slots carry q_pos = -1, which the kernels
    mask."""
    bh, nq_p, _ = qf.shape
    if nq_p != nq:
        row = torch.arange(nq_p, device=qf.device)[None, :, None]
        sel = torch.where(row < nq, sel, nb)
    lay = routing.build_varlen_layout(sel, nq_p, nb, tile)
    rows = torch.arange(bh, device=qf.device)[:, None]
    qi = lay.q_index.long().clamp(min=0)                      # (BH, L)
    q_pos = torch.where(lay.q_index >= 0, qi + q_pos_offset,
                        -1).to(torch.int32)
    return lay, qf[rows, qi], q_pos


def _fwd_pipeline(q, k, v, meta: _Meta):
    b, h, nq, d = q.shape
    _, hkv, n, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    bs, tk = meta.block_size, meta.top_k
    tile = min(meta.q_tile, nq)
    bh = b * h

    k_blocks, nb = flatten_kv_blocks(k, bs)
    v_blocks, _ = flatten_kv_blocks(v, bs)
    cents = block_centroids_kernel(k.reshape(b * hkv, n, d), bs)
    qf = padded_queries(q, tile)
    nq_p = qf.shape[1]
    sel = flash_topk(qf, cents, tk, bs, group=g, num_q_heads=h,
                     causal=meta.causal, q_pos_offset=n - nq,
                     q_tile=tile, grid=meta.grid)             # (BH, Nq_p, k)
    lay, q_sorted, q_pos = sorted_layout(qf, sel, nq, nb, tile, n - nq)

    o_l, m_l, l_l = moba_fwd(
        lay.tile_block, q_sorted, q_pos, k_blocks, v_blocks,
        scale=meta.scale, block_size=bs, n_tokens=n, num_q_heads=h,
        group=g, causal=meta.causal, q_tile=tile, kb_tile=meta.kb_tile,
        grid=meta.grid)

    rows = torch.arange(bh, device=q.device)[:, None]
    slots = lay.pair_slot.reshape(bh, nq_p * tk).long()
    out, lse = merge_partials(o_l[rows, slots].reshape(bh, nq_p, tk, dv),
                              m_l.gather(1, slots).reshape(bh, nq_p, tk),
                              l_l.gather(1, slots).reshape(bh, nq_p, tk))
    return out[:, :nq], lse[:, :nq], lay, q_sorted, q_pos


class FlashMoBA(torch.autograd.Function):
    """Forward: the FlashMoBA pipeline; backward: the backward kernel.
    Saves the reference's residuals (``ops.py:132-137`` there)."""

    @staticmethod
    def forward(ctx, q, k, v, meta: _Meta):
        with tracing.span("kernel.flash_moba"):
            out, lse, lay, q_sorted, q_pos = _fwd_pipeline(q, k, v, meta)
            ctx.meta = meta
            ctx.save_for_backward(q, k, v, out, lse, lay.tile_block,
                                  lay.pair_slot, q_sorted, q_pos)
            b, h, nq, _ = q.shape
            return out.reshape(b, h, nq, v.shape[-1]).to(q.dtype)

    @staticmethod
    def backward(ctx, g_out):
        with tracing.span("kernel.flash_moba_bwd"):
            return FlashMoBA._backward(ctx, g_out)

    @staticmethod
    def _backward(ctx, g_out):
        meta = ctx.meta
        q, k, v, out, lse, tile_block, pair_slot, q_sorted, q_pos = \
            ctx.saved_tensors
        b, h, nq, d = q.shape
        _, hkv, n, _ = k.shape
        dvw = v.shape[-1]
        g = h // hkv
        bs, tk = meta.block_size, meta.top_k
        tile = min(meta.q_tile, nq)
        bh = b * h
        nq_p = pair_slot.shape[1]

        k_blocks, nb = flatten_kv_blocks(k, bs)
        v_blocks, _ = flatten_kv_blocks(v, bs)

        do = g_out.contiguous().reshape(bh, nq, dvw)
        delta = (do.float() * out).sum(dim=-1)                # (BH, Nq)

        # per-query tensors to the sorted layout, dO in the kernel's dtype
        # (q's: bf16 on the training path) and lse/delta in fp32 (q_pos =
        # -1 pad and sentinel slots gather row 0 but are masked inside the
        # kernel)
        rows = torch.arange(bh, device=q.device)[:, None]
        qi = (q_pos.long() - (n - nq)).clamp(min=0)
        do_sorted = do.to(q_sorted.dtype)[rows, qi]
        lse_sorted = lse.gather(1, qi)
        delta_sorted = delta.gather(1, qi)

        dq_l, dk_bh, dv_bh = moba_bwd(
            tile_block, q_sorted, q_pos, do_sorted, lse_sorted, delta_sorted,
            k_blocks, v_blocks, scale=meta.scale, block_size=bs,
            n_tokens=n, num_q_heads=h, group=g, causal=meta.causal,
            q_tile=tile, kb_tile=meta.kb_tile, grid=meta.grid)

        # dQ: gather per-pair contributions and sum over the k slots
        slots = pair_slot.reshape(bh, nq_p * tk).long()
        dq = dq_l[rows, slots].reshape(bh, nq_p, tk, d).sum(dim=2)[:, :nq]

        # dK/dV: zero unvisited blocks, reduce over the GQA group, un-block
        visited = torch.zeros((bh, nb + 1), dtype=torch.bool,
                              device=q.device)
        visited.scatter_(1, tile_block.long(), True)
        visited = visited[:, :nb, None, None]
        dk = (dk_bh * visited).reshape(b, hkv, g, nb, bs, d).sum(dim=2)
        dv = (dv_bh * visited).reshape(b, hkv, g, nb, bs, dvw).sum(dim=2)
        dk = dk.reshape(b, hkv, nb * bs, d)[:, :, :n]
        dv = dv.reshape(b, hkv, nb * bs, dvw)[:, :, :n]
        return (dq.reshape(b, h, nq, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None)


def flash_moba(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: MoBAConfig, q_positions: Optional[torch.Tensor] = None,
               scale: Optional[float] = None, q_tile: int = 128,
               kb_tile: int = 0, grid: str = "grouped") -> torch.Tensor:
    """FlashMoBA attention through the Hopper kernels.

    q (B, H, Nq, d); k (B, Hkv, N, d); v (B, Hkv, N, dv) (dv = d but for
    latent attention's 192 / 128); the output is dv wide.  The queries
    are the contiguous suffix of the keys (training / prefill), so
    ``q_positions`` is not read; it stays for the reference's signature.
    ``grid`` ('grouped' | 'flat') and ``kb_tile`` (the forward's K/V
    streaming granularity, 0 = auto) keep the reference's options.  Nq
    may be ragged.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    meta = _Meta(cfg.block_size, cfg.top_k, cfg.causal, q_tile,
                 float(scale), kb_tile, grid)
    return FlashMoBA.apply(q, k, v, meta)
