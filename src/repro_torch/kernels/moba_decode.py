"""Paged MoBA decode: the Hopper kernel's wrapper and its page union.

Replaces ``repro.kernels.moba_decode.moba_paged_decode_pallas`` (the
TPU's scalar-prefetched Pallas kernel, grids ``grouped`` and ``flat``).
The CUDA kernel is ``csrc/moba_decode.cu``; its header says what bounds
it on an H100 (bytes) and what the design does about that.

The wrapper does what the reference wrapper did before its
``pallas_call`` (``moba_decode.py:165-202`` there): routing on the
per-page centroid cache (:func:`repro_torch.core.moba.moba_paged_route`),
the GQA group's page union (:func:`union_pages`), the physical page
table, the per-(head, slot) token offsets, then ONE launch.  Both grid
names reach the same kernel.

Device contract: a CPU tensor takes the plain PyTorch version
(``core.moba.moba_paged_decode_attention``); a CUDA tensor launches the
kernel or raises — there is no fallback.  The kernel takes q in bf16 or
fp32 and pools either in q's dtype or quantized (int8 or fp8 e4m3 "fn"
payloads with fp32 (P, Hkv) ``scales_k``/``scales_v``, dequantized in the
kernel); head_dim 64 or 128; page_size a multiple of 16 up to 256; GQA
group G <= 8.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its decode steps went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MoBAConfig
from repro_torch.core import quantization as Q
from repro_torch.core.moba import (moba_paged_decode_attention,
                                   moba_paged_route)
from repro_torch.kernels import runtime

LAUNCHES = 0

GRIDS = ("grouped", "flat")
_HEAD_DIMS = (64, 128)
_MAX_PAGE = 256
_MAX_GROUP = 8


def union_pages(idx: torch.Tensor, sel_valid: torch.Tensor, npg: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate the GQA group's page selection per (batch, kv head).

    idx/sel_valid: (B, Hkv, G, 1, k) from ``moba_paged_route``.  Returns
    ``(union, n_uniq)`` with ``union`` (B, Hkv, U) int32 logical page
    ids — unique pages sorted ascending and compacted to the front,
    U = G·k, padding slots 0 — and ``n_uniq`` (B, Hkv) int32 the number
    of valid entries.
    """
    b, hkv, g, _, tk = idx.shape
    cap = g * tk
    ids = torch.where(sel_valid, idx, npg).reshape(b, hkv, cap)
    s = torch.sort(ids, dim=-1).values
    first = torch.cat([torch.ones_like(s[..., :1], dtype=torch.bool),
                       s[..., 1:] != s[..., :-1]], dim=-1)
    uniq = first & (s < npg)
    rank = torch.cumsum(uniq.to(torch.int64), dim=-1) - 1
    tgt = torch.where(uniq, rank, cap)           # cap == drop slot
    union = torch.zeros((b, hkv, cap + 1), dtype=torch.int64,
                        device=idx.device)
    union.scatter_(-1, tgt, s.to(torch.int64))
    return (union[..., :cap].to(torch.int32),
            uniq.sum(dim=-1).to(torch.int32))


def check_contract(q: torch.Tensor, pages_k: torch.Tensor,
                   pages_v: torch.Tensor,
                   scales_k: Optional[torch.Tensor] = None,
                   scales_v: Optional[torch.Tensor] = None) -> None:
    """Raise a shaped error for inputs the CUDA kernel does not take."""
    b, h, one, d = q.shape
    num_pages, ps, hkv, _ = pages_k.shape
    problems = []
    if one != 1:
        problems.append(f"one query token per row (got {one})")
    if q.dtype not in runtime.DTYPE_CODES:
        problems.append(f"q dtype bf16 or fp32 (got {q.dtype})")
    if pages_v.dtype != pages_k.dtype:
        problems.append(f"K/V pools of one dtype (got "
                        f"{pages_k.dtype}/{pages_v.dtype})")
    elif Q.kv_dtype_of(pages_k.dtype) != "fp32":
        want = (num_pages, hkv)
        for name, sc in (("scales_k", scales_k), ("scales_v", scales_v)):
            if sc is None or sc.dtype != torch.float32 \
                    or tuple(sc.shape) != want or not sc.is_contiguous():
                got = None if sc is None else (tuple(sc.shape), sc.dtype)
                problems.append(f"a quantized pool's {name} as contiguous "
                                f"fp32 {want} (got {got})")
    elif pages_k.dtype != q.dtype:
        problems.append(f"pools in q's dtype {q.dtype}, or int8/fp8 "
                        f"payloads with scales (got {pages_k.dtype})")
    elif scales_k is not None or scales_v is not None:
        problems.append("no scales for an unquantized pool")
    if d not in _HEAD_DIMS:
        problems.append(f"head_dim in {_HEAD_DIMS} (got {d})")
    if ps % 16 or not 16 <= ps <= _MAX_PAGE:
        problems.append(f"page_size a multiple of 16 up to {_MAX_PAGE} "
                        f"(got {ps})")
    if h % hkv or h // hkv > _MAX_GROUP:
        problems.append(f"GQA group H/Hkv <= {_MAX_GROUP} (got H={h}, "
                        f"Hkv={hkv})")
    if pages_v.shape != pages_k.shape:
        problems.append(f"K/V pools of one shape (got "
                        f"{tuple(pages_k.shape)}/{tuple(pages_v.shape)})")
    if not (pages_k.is_contiguous() and pages_v.is_contiguous()):
        problems.append("contiguous (P, page_size, Hkv, d) pools")
    if b < 1:
        problems.append("a non-empty batch")
    if problems:
        raise ValueError(
            f"moba_paged_decode CUDA kernel needs "
            f"{'; '.join(problems)} — q {tuple(q.shape)}, pool "
            f"{tuple(pages_k.shape)}")


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def decode_tables(q: torch.Tensor, pages_k: torch.Tensor,
                  block_table: torch.Tensor, idx: torch.Tensor,
                  sel_valid: torch.Tensor):
    """The kernel's per-row tables from a route: physical page of every
    union slot (B·Hkv, U), per-(head, slot) token offsets (B·Hkv, G, U)
    with the npg·ps sentinel for heads that did not select the page, and
    the union sizes (B·Hkv,)."""
    b, h, _, _ = q.shape
    num_pages, ps, hkv, _ = pages_k.shape
    npg = block_table.shape[1]
    g = h // hkv
    cap = g * idx.shape[-1]
    union, n_uniq = union_pages(idx, sel_valid, npg)         # (B,Hkv,U)
    tbl = block_table.clamp(min=0).long()
    rows = torch.arange(b, device=q.device)[:, None, None]
    phys = tbl[rows, union.long()].clamp(0, num_pages - 1)
    ids_g = torch.where(sel_valid, idx, npg)[:, :, :, 0, :]  # (B,Hkv,G,k)
    member = (ids_g[..., None] == union[:, :, None, None, :]).any(dim=3)
    member = member & (torch.arange(cap, device=q.device)[None, None, None]
                       < n_uniq[:, :, None, None])           # (B,Hkv,G,U)
    base = torch.where(member, (union * ps)[:, :, None, :], npg * ps)
    return (phys.reshape(b * hkv, cap).to(torch.int32).contiguous(),
            base.reshape(b * hkv, g, cap).to(torch.int32).contiguous(),
            n_uniq.reshape(b * hkv).contiguous())


def launch(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
           kv_len: torch.Tensor, phys: torch.Tensor, base: torch.Tensor,
           n_uniq: torch.Tensor, scale: float,
           scales_k: Optional[torch.Tensor] = None,
           scales_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the CUDA kernel on precomputed tables (the scales
    of a quantized pool, or None)."""
    global LAUNCHES
    b, h, _, d = q.shape
    _, ps, hkv, _ = pages_k.shape
    g = h // hkv
    cap = phys.shape[1]
    q_rows = q[:, :, 0, :].reshape(b * hkv, g, d).contiguous()
    kvl = kv_len.to(torch.int32).contiguous()
    out = torch.empty_like(q_rows)
    ptr = runtime.ptr
    sk = None if scales_k is None else ptr(scales_k)
    sv = None if scales_v is None else ptr(scales_v)
    lib = runtime.bind("moba_decode", "moba_paged_decode", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.moba_paged_decode(
            ptr(q_rows), ptr(pages_k), ptr(pages_v), sk, sv,
            ptr(phys), ptr(base), ptr(n_uniq), ptr(kvl), ptr(out),
            b * hkv, hkv, g, cap, ps, d, float(scale),
            runtime.DTYPE_CODES[q.dtype],
            runtime.PAYLOAD_CODES[pages_k.dtype], runtime.stream_of(q))
    runtime.check(err, f"moba_paged_decode (q {tuple(q.shape)}, pool "
                       f"{tuple(pages_k.shape)})")
    LAUNCHES += 1
    return out.reshape(b, h, 1, d)


def moba_paged_decode(q: torch.Tensor, pages_k: torch.Tensor,
                      pages_v: torch.Tensor, centroids: torch.Tensor,
                      block_table: torch.Tensor, kv_len: torch.Tensor,
                      cfg: MoBAConfig, scale: Optional[float] = None,
                      grid: str = "grouped",
                      scales_k: Optional[torch.Tensor] = None,
                      scales_v: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Drop-in for ``core.moba.moba_paged_decode_attention`` (same
    contract): q (B, H, 1, d); pages_k/v (P, page_size, Hkv, d);
    centroids (P, Hkv, d) fp32; block_table (B, npg) int32, -1 =
    unassigned; kv_len (B,) post-append lengths; scales_k/v (P, Hkv)
    fp32 for a quantized pool, else None.  Rows with ``kv_len`` 0
    return zeros on the card.

    ``grid`` keeps the reference's API ("grouped" | "flat"); on Hopper
    both reach the one kernel.
    """
    if grid not in GRIDS:
        raise ValueError(f"unknown decode grid {grid!r}: expected "
                         f"'grouped' or 'flat'")
    if q.device.type == "cpu":
        return moba_paged_decode_attention(q, pages_k, pages_v, centroids,
                                           block_table, kv_len, cfg,
                                           scale=scale, scales_k=scales_k,
                                           scales_v=scales_v)
    if q.device.type != "cuda":
        raise ValueError(f"moba_paged_decode: tensors on {q.device}; "
                         f"expected cpu (plain version) or cuda (kernel)")
    check_contract(q, pages_k, pages_v, scales_k, scales_v)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    idx, sel_valid = moba_paged_route(q, centroids, block_table, kv_len,
                                      cfg, page_size=pages_k.shape[1])
    phys, base, n_uniq = decode_tables(q, pages_k, block_table, idx,
                                       sel_valid)
    return launch(q, pages_k, pages_v, kv_len, phys, base, n_uniq, scale,
                  scales_k, scales_v)
