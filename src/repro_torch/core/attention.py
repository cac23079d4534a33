"""Dense and sliding-window attention + the per-layer dispatcher.

These are the baselines the paper compares against (dense) and interleaves
with (SWA, window 256, odd layers).  All math in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttentionConfig

NEG_INF = -1e30


def _grouped_scores(q, k, scale):
    b, h, nq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, nq, d).float()
    s = torch.einsum("bhgqd,bhsd->bhgqs", qg, k.float()) * scale
    return s.reshape(b, h, nq, k.shape[2])


def _apply_and_project(p, v, out_dtype):
    b, h, nq, n = p.shape
    hkv = v.shape[1]
    pg = p.reshape(b, hkv, h // hkv, nq, n)
    o = torch.einsum("bhgqs,bhsd->bhgqd", pg, v.float())
    return o.reshape(b, h, nq, v.shape[-1]).to(out_dtype)


def dense_attention(q, k, v, causal: bool = True,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_len=None, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Dense (optionally sliding-window) attention with GQA grouping.

    window > 0 keeps keys with q_pos - window < s <= q_pos.
    ``q_positions`` may be (Nq,) shared or (B, Nq) per-sequence (ragged
    serving batches); ``kv_len`` a scalar or (B,) per-sequence lengths.
    """
    b, h, nq, d = q.shape
    n = k.shape[2]
    dev = q.device
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_positions is None:
        q_positions = torch.arange(nq, device=dev) + (n - nq)
    s = _grouped_scores(q, k, scale)
    spos = torch.arange(n, device=dev)
    qp = torch.as_tensor(q_positions, device=dev)
    qp = qp[None] if qp.ndim == 1 else qp                    # (1|B, Nq)
    mask = torch.ones((qp.shape[0], nq, n), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (qp[:, :, None] >= spos[None, None, :])
    if window:
        mask = mask & (qp[:, :, None] - spos[None, None, :] < window)
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=dev)
        kvl = kvl.reshape(-1, 1, 1) if kvl.ndim else kvl
        mask = mask & (spos[None, None, :] < kvl)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, :, None], p, 0.0)
    return _apply_and_project(p, v, q.dtype)


def attention_dispatch(cfg: AttentionConfig, kind: str, q, k, v,
                       q_positions=None, kv_len=None,
                       backend: str = "reference", causal: bool = True,
                       centroids=None) -> torch.Tensor:
    """Route to a registered attention backend (``core.backends``) by
    name + capability query.

    ``kind`` ∈ {dense, swa, moba} selects the layer behaviour; ``backend``
    selects the implementation.  Single-token calls against a dense cache
    (``q`` length 1 with ``kv_len``) resolve the decode phase, with
    ``centroids`` the MoBA layer's incremental centroid cache; everything
    else the prefill phase.  Paged pools go through the backends' paged
    methods instead (``models/layers.py``).
    """
    from repro_torch.core import backends as B

    if q.shape[2] == 1 and kv_len is not None:
        be = B.resolve(backend, kind=kind, phase="decode", cache="dense")
        return be.decode(cfg, kind, q, k, v, kv_len, centroids=centroids,
                         q_positions=q_positions)
    be = B.resolve(backend, kind=kind, phase="prefill", cache="dense")
    return be.prefill(cfg, kind, q, k, v, q_positions=q_positions,
                      kv_len=kv_len, causal=causal)
