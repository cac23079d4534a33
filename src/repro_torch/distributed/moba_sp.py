"""Sequence-parallel (SP) MoBA attention for training and prefill, and
context-parallel (CP) MoBA decode, over the shards of a :class:`CPGroup`,
one device each (a device may host several shards).

* **SP (training and prefill)**: the queries are split over the shards
  on the sequence dim and K/V are copied to each shard.  Routing is per
  query, so every shard routes and attends its own queries against the
  whole K/V with nothing exchanged inside the attention; the K/V copies
  are the entire forward cost.  Training differentiates through it: each
  shard's attention runs under ``torch.utils.checkpoint`` (the
  reference's ``jax.checkpoint``, the paper's backward with
  recomputation), so a shard keeps only its inputs and the backward
  rebuilds its tiles; dQ slices, dK and dV come back to the lead, where
  autograd sums the shards' dK and dV (:func:`sp_attention_bytes`).
* **CP (decode)**: the KV cache and its centroid cache live as S
  sequence segments, segment s on shard s's device.  Each shard scores
  its own centroids and proposes its local top-k; every shard takes the
  global top-k of the gathered tp·k candidates; each attends only the
  selected blocks it owns, and the (o, m, l) partials merge by
  log-sum-exp on the lead shard.  Per step and query head that moves
  the query (d values), tp·(tp-1)·k candidates (score and block id)
  and (tp-1)·(d+2) partial floats, against the O(N·d) of gathering the
  cache (:func:`cp_decode_bytes`).

The reference runs both as ``shard_map`` bodies whose collectives cross
devices.  Here one host process drives every shard, and every tensor
that passes from one shard to another goes through :meth:`CPGroup.send`,
which counts its bytes by kind, and the bytes of its gradient under
``<kind>_grad``; nothing else crosses.  Shard 0's device is the lead:
the rest of the model runs there, and the queries come from and the
outputs go back to it.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import MoBAConfig
from repro_torch.core import routing
from repro_torch.kernels import ref as kref

NEG_INF = routing.NEG_INF


class CPGroup:
    """The devices of the shards taking part in SP/CP attention, and the
    one place tensors move between them.  ``bytes`` counts what
    :meth:`send` moved from one shard to another, by kind, and what the
    backward moved back under ``<kind>_grad``: shards that share a
    device count too, since on separate cards the same bytes would
    cross."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a context-parallel group needs a device")
        self.devices = [torch.device(d) for d in devices]
        self.bytes: Dict[str, int] = collections.Counter()

    @property
    def size(self) -> int:
        return len(self.devices)

    def send(self, x: torch.Tensor, src: int, dst: int,
             kind: str) -> torch.Tensor:
        """``x`` (held by shard ``src``) on shard ``dst``'s device; its
        gradient goes back to ``src`` and counts under ``<kind>_grad``."""
        if src == dst:
            return x.to(self.devices[dst], non_blocking=True)
        self.bytes[kind] += x.numel() * x.element_size()
        return _Send.apply(x, self, src, dst, kind)


class _Send(torch.autograd.Function):
    """``.to()`` between two shards whose backward counts the gradient's
    bytes as it moves back."""

    @staticmethod
    def forward(ctx, x, group: CPGroup, src: int, dst: int, kind: str):
        ctx.group, ctx.src, ctx.kind = group, src, kind
        return x.to(group.devices[dst], non_blocking=True)

    @staticmethod
    def backward(ctx, grad):
        ctx.group.bytes[ctx.kind + "_grad"] += grad.numel() \
            * grad.element_size()
        return (grad.to(ctx.group.devices[ctx.src], non_blocking=True),
                None, None, None, None)


_ACTIVE: List[Optional[CPGroup]] = [None]


@contextlib.contextmanager
def use_group(group: Optional[CPGroup]):
    """Make ``group`` the one the ``sp`` backends' calls run over (the
    reference's ``use_mesh``)."""
    prev, _ACTIVE[0] = _ACTIVE[0], group
    try:
        yield group
    finally:
        _ACTIVE[0] = prev


def active_group() -> Optional[CPGroup]:
    return _ACTIVE[0]


def cp_decode_bytes(b: int, h: int, d: int, top_k: int, tp: int,
                    q_itemsize: int) -> Dict[str, int]:
    """Bytes one :func:`moba_decode_cp` call moves between shards, by
    kind: the query to tp-1 shards, the all-gather of every shard's k
    candidates (fp32 score, int32 block id) to the tp-1 others, and the
    (o, m, l) partials (fp32) of tp-1 shards to the lead."""
    return {"q": (tp - 1) * b * h * d * q_itemsize,
            "candidates": tp * (tp - 1) * b * h * top_k * (4 + 4),
            "partials": (tp - 1) * b * h * (d + 2) * 4}


def sp_attention_bytes(b: int, h: int, hkv: int, nq: int, n: int, d: int,
                       tp: int, itemsize: int,
                       positions_itemsize: int = 0) -> Dict[str, int]:
    """Bytes one :func:`moba_attention_sp` call over tp shards moves
    between shards in its forward and backward, by kind: the queries'
    slices to tp-1 shards, K and V to tp-1 shards, the outputs' slices
    back to the lead, and their gradients the other way (``q_grad``: dQ
    slices to the lead; ``kv_grad``: each shard's dK and dV to the lead;
    ``out_grad``: dO slices to the shards).  Every tensor in the dtype
    of q, k and v (``itemsize`` bytes).  Explicit query positions
    (``positions_itemsize`` bytes each; the model's layers pass them)
    go to tp-1 shards as ``positions``."""
    q_part = (tp - 1) * b * h * (nq // tp) * d * itemsize
    out = {"q": q_part, "kv": 2 * (tp - 1) * b * hkv * n * d * itemsize,
           "out": q_part}
    out.update({f"{k}_grad": v for k, v in list(out.items())})
    if positions_itemsize:
        out["positions"] = (tp - 1) * (nq // tp) * positions_itemsize
    return out


# ------------------------------------------------------- SP attention
def moba_attention_sp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: MoBAConfig, scale: Optional[float] = None,
                      q_positions: Optional[torch.Tensor] = None,
                      tile: int = 128,
                      group: Optional[CPGroup] = None) -> torch.Tensor:
    """SP MoBA: q (B, H, Nq, d) split over the group's shards on the
    sequence dim, k, v (B, Hkv, N, d) copied to each.  Shard s runs
    ``kernels/ref.py::moba_sparse_xla`` on its Nq/tp queries at positions
    ``q_positions``' slice (default ``s·Nq/tp + arange + N - Nq``, the
    reference's); the outputs come back to the lead in order.  Plain
    ``moba_sparse_xla`` without a group (``group`` or the active one),
    with one shard, or when tp does not divide Nq.

    Differentiable: each shard's call runs under
    ``torch.utils.checkpoint``, so the autograd graph keeps only the
    shard's inputs and the backward recomputes its tiles (routing is
    not differentiated, as in ``moba_sparse_xla``).  The gradients cross
    back through :meth:`CPGroup.send`, counted under ``q_grad``,
    ``kv_grad`` and ``out_grad`` (:func:`sp_attention_bytes`)."""
    b, h, nq, d = q.shape
    n = k.shape[2]
    group = group or active_group()
    tp = group.size if group is not None else 1
    if group is None or tp == 1 or nq % tp:
        return kref.moba_sparse_xla(q, k, v, cfg, q_positions=q_positions,
                                    scale=scale, tile=tile)
    nq_local = nq // tp

    def shard_fn(q_s, k_s, v_s, pos):
        return kref.moba_sparse_xla(q_s, k_s, v_s, cfg, q_positions=pos,
                                    scale=scale, tile=min(tile, nq_local))

    outs = []
    for s, dev in enumerate(group.devices):
        rows = slice(s * nq_local, (s + 1) * nq_local)
        if q_positions is None:
            pos = torch.arange(nq_local, device=dev) + s * nq_local + n - nq
        else:
            pos = group.send(torch.as_tensor(q_positions)[rows], 0, s,
                             "positions")
        args = (group.send(q[:, :, rows], 0, s, "q"),
                group.send(k, 0, s, "kv"), group.send(v, 0, s, "kv"), pos)
        o = (torch.utils.checkpoint.checkpoint(shard_fn, *args,
                                               use_reentrant=False)
             if torch.is_grad_enabled() else shard_fn(*args))
        outs.append(group.send(o, s, 0, "out"))
    return torch.cat(outs, dim=2)


# ------------------------------------------------------------- CP decode
def split_segments(x: torch.Tensor, group: CPGroup,
                   kind: str = "scatter") -> List[torch.Tensor]:
    """``x`` (…, N, d) cut into ``group.size`` equal sequence segments
    (dim -2), segment s sent to shard s."""
    n_local = x.shape[-2] // group.size
    return [group.send(x[..., s * n_local:(s + 1) * n_local, :].contiguous(),
                       0, s, kind) for s in range(group.size)]


def append_segments(k_segs: List[torch.Tensor], v_segs: List[torch.Tensor],
                    c_segs: Optional[List[torch.Tensor]], k: torch.Tensor,
                    v: torch.Tensor, start: int, block_size: int,
                    group: CPGroup) -> None:
    """Write the n new tokens k, v (…, Hkv, n, d) at positions [start,
    start + n) into the segments that own them (each token to its
    shard's device, kind ``append``), in place.  The centroid segments
    follow the dense cache's rule (``models/layers.py``): one decode
    token updates its block's centroid by ``(old·m + k) / (m + 1)``; a
    prefill rebuilds each segment's centroids over its valid part."""
    n_local = k_segs[0].shape[-2]
    n = k.shape[-2]
    end = start + n
    for s in range(start // n_local, min(-(-end // n_local), len(k_segs))):
        lo, hi = max(start, s * n_local), min(end, (s + 1) * n_local)
        ks = group.send(k[..., lo - start:hi - start, :], 0, s, "append")
        vs = group.send(v[..., lo - start:hi - start, :], 0, s, "append")
        seg_k, off = k_segs[s], lo - s * n_local
        seg_k[..., off:off + hi - lo, :] = ks.to(seg_k.dtype)
        v_segs[s][..., off:off + hi - lo, :] = vs.to(v_segs[s].dtype)
        if c_segs is None:
            continue
        c = c_segs[s]
        if n == 1:
            j, m = off // block_size, off % block_size
            old = c[..., j:j + 1, :]
            c[..., j:j + 1, :] = (old * m + ks.float()) / old.new_full(
                (), m + 1)
        else:
            c.copy_(routing.block_centroids(seg_k, block_size,
                                            kv_len=end - s * n_local)
                    .float())


def _scalar_len(kv_len) -> int:
    kvl = torch.as_tensor(kv_len)
    if kvl.numel() != 1:
        raise ValueError(f"context-parallel decode takes one kv_len for "
                         f"the batch, got shape {tuple(kvl.shape)}")
    return int(kvl)


def _local_candidates(qg, k_seg, c_seg, kvl: int, base: int, bs: int,
                      tk: int):
    """Shard-local routing: the masked scores of this segment's blocks
    (invalid ``NEG_INF``, the own block ``POS_INF``) and their top-k in
    ``lax.top_k``'s order, padded with ``NEG_INF`` / id 0 to k; ids are
    global block ids."""
    b, hkv, n_local, d = k_seg.shape
    nb_local = n_local // bs
    dev = k_seg.device
    blk = torch.arange(nb_local, device=dev)
    if c_seg is not None:
        cents = c_seg.float()
    else:
        kb = k_seg.reshape(b, hkv, nb_local, bs, d).float()
        pos = base + blk[:, None] * bs + torch.arange(bs, device=dev)
        valid = pos < kvl
        denom = valid.sum(-1).clamp(min=1).float()
        cents = (kb * valid[..., None]).sum(-2) / denom[:, None]
    scores = torch.einsum("bhgd,bhnd->bhgn", qg, cents)
    masked = torch.where(base + blk * bs < kvl, scores, NEG_INF)
    own = max(kvl - 1, 0) // bs
    masked = torch.where(base // bs + blk == own, routing.POS_INF, masked)
    loc_s, loc_i = routing.topk_desc(masked, min(tk, nb_local))
    if loc_s.shape[-1] < tk:
        pad = loc_s.shape[:-1] + (tk - loc_s.shape[-1],)
        loc_s = torch.cat([loc_s, loc_s.new_full(pad, NEG_INF)], -1)
        loc_i = torch.cat([loc_i, loc_i.new_zeros(pad)], -1)
    return loc_s, (base // bs + loc_i).to(torch.int32)


def _local_partials(qg, k_seg, v_seg, gtop_i, gsel_valid, kvl: int,
                    base: int, bs: int, scale: float):
    """(o, m, l) of this shard's share of the selection: the selected
    blocks it owns, one fp32 softmax pass over their valid tokens."""
    b, hkv, n_local, d = k_seg.shape
    nb_local = n_local // bs
    dev = k_seg.device
    first = base // bs
    here = gsel_valid & (gtop_i >= first) & (gtop_i < first + nb_local)
    loc = (gtop_i.long() - first).clamp(0, nb_local - 1)     # (B,Hkv,G,k)
    rows = torch.arange(b, device=dev)[:, None, None, None]
    heads = torch.arange(hkv, device=dev)[None, :, None, None]
    kg = k_seg.reshape(b, hkv, nb_local, bs, d)[rows, heads, loc].float()
    vg = v_seg.reshape(b, hkv, nb_local, bs, d)[rows, heads, loc].float()
    s = torch.einsum("bhgd,bhgkld->bhgkl", qg, kg) * scale
    tok = base + loc[..., None] * bs + torch.arange(bs, device=dev)
    s = torch.where((tok < kvl) & here[..., None], s, NEG_INF)
    sf = s.reshape(*s.shape[:3], -1)
    m = sf.max(-1).values
    p = torch.exp(sf - m.clamp(min=NEG_INF / 2)[..., None]) \
        * (sf > NEG_INF / 2)
    l = p.sum(-1)
    o = torch.einsum("bhgx,bhgxd->bhgd", p, vg.reshape(b, hkv, *p.shape[2:],
                                                      d))
    return o, torch.where(l > 0, m, NEG_INF), l


def cp_select(q: torch.Tensor, k_segs: List[torch.Tensor], kv_len,
              cfg: MoBAConfig, c_segs=None, group: Optional[CPGroup] = None):
    """The distributed selection of :func:`moba_decode_cp`: for each
    shard, its copy of the global top-k, (ids (B, Hkv, G, k) int32 on
    the shard's device, validity).  Every copy is the same: each shard
    orders the same gathered candidates in shard order."""
    return _cp(q, k_segs, None, kv_len, cfg, None, c_segs, group)[1]


def _cp(q, k_segs, v_segs, kv_len, cfg, scale, c_segs, group):
    b, h, _, d = q.shape
    hkv, n_local = k_segs[0].shape[1], k_segs[0].shape[2]
    bs, tk = cfg.block_size, cfg.top_k
    if group is None:
        group = CPGroup([x.device for x in k_segs])
    tp = group.size
    if len(k_segs) != tp or n_local % bs \
            or any(x.shape != k_segs[0].shape for x in k_segs):
        raise ValueError(
            f"context-parallel decode needs {tp} equal segments of whole "
            f"{bs}-token blocks, got {[tuple(x.shape) for x in k_segs]}")
    kvl = _scalar_len(kv_len)
    qg = [group.send(q, 0, s, "q").reshape(b, hkv, h // hkv, d).float()
          for s in range(tp)]
    cand = [_local_candidates(qg[s], k_segs[s],
                              None if c_segs is None else c_segs[s], kvl,
                              s * n_local, bs, tk) for s in range(tp)]
    selected = []
    for s in range(tp):       # the all-gather, then each shard's top-k
        all_s = torch.cat([group.send(c[0], t, s, "candidates")
                           for t, c in enumerate(cand)], -1)
        all_i = torch.cat([group.send(c[1], t, s, "candidates")
                           for t, c in enumerate(cand)], -1)
        gtop_s, at = routing.topk_desc(all_s, tk)
        selected.append((all_i.gather(-1, at), gtop_s > NEG_INF / 2))
    if v_segs is None:
        return qg, selected, None
    parts = []
    for s in range(tp):
        o, m, l = _local_partials(qg[s], k_segs[s], v_segs[s], *selected[s],
                                  kvl, s * n_local, bs, scale)
        parts.append([group.send(x, s, 0, "partials") for x in (o, m, l)])
    o_all, m_all, l_all = (torch.stack(x) for x in zip(*parts))
    mm = m_all.max(0).values.clamp(min=NEG_INF / 2)
    w = torch.exp(m_all - mm)
    lt = (l_all * w).sum(0).clamp(min=1e-30)
    out = (o_all * w[..., None]).sum(0) / lt[..., None]
    return qg, selected, out.reshape(b, h, 1, d).to(q.dtype)


def moba_decode_cp(q: torch.Tensor, k_cache, v_cache, kv_len,
                   cfg: MoBAConfig, scale: Optional[float] = None,
                   centroids=None,
                   group: Optional[CPGroup] = None) -> torch.Tensor:
    """Context-parallel MoBA decode: q (B, H, 1, d) on the lead device
    against caches held as segments, lists of tp (B, Hkv, Nmax/tp, d)
    tensors (``centroids``: (B, Hkv, nb/tp, d) fp32 segments, or None to
    recompute them), segment s on shard s's device; ``kv_len`` one length
    for the batch.  Local candidates, global agreement, local block
    attention, log-sum-exp merge (module docstring).

    Whole (B, Hkv, Nmax, d) caches are first cut into segments (kind
    ``scatter``); they fall back to the single-device
    ``core/moba.py::moba_decode_attention`` without a group, or when
    ``Nmax`` is not a multiple of tp · block_size, as the reference
    degrades on an awkward cache length."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    group = group or active_group()
    if isinstance(k_cache, torch.Tensor):
        tp = group.size if group is not None else 1
        if group is None or k_cache.shape[2] % (tp * cfg.block_size):
            from repro_torch.core.moba import moba_decode_attention
            return moba_decode_attention(q, k_cache, v_cache, kv_len, cfg,
                                         scale=scale, centroids=centroids)
        k_cache = split_segments(k_cache, group)
        v_cache = split_segments(v_cache, group)
        if centroids is not None:
            centroids = split_segments(centroids, group)
    return _cp(q, k_cache, v_cache, kv_len, cfg, scale, centroids,
               group)[2]
