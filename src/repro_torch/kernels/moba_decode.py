"""Paged MoBA decode: the Hopper kernels' wrapper and their plain pieces.

Replaces ``repro.kernels.moba_decode.moba_paged_decode_pallas`` (the
TPU's scalar-prefetched Pallas kernel, grids ``grouped`` and ``flat``)
and the routing its wrapper runs before the ``pallas_call``.  The CUDA
source is ``csrc/moba_decode.cu``; its header says what bounds the
decode on an H100 (bytes) and what the design does about that.

On a CUDA tensor one call of :func:`moba_paged_decode` makes one C call
that launches three kernels on the current stream: the route (scores on
the per-page centroid cache, top-k per query head, the GQA group's page
union and the kernel tables, all on the card), the split-page attention
(one CTA per (sequence, kv head, union slot, token chunk), writing one
online-softmax partial each) and the merge of the partials in slot
order.  The wrapper only checks the inputs, plans the grids
(:func:`plan`) and allocates the tables and partials with
``torch.empty``; it runs no PyTorch operator that does device work.
Both grid names reach the same kernels.

Device contract: a CPU tensor takes the plain PyTorch version
(``core.moba.moba_paged_decode_attention``); a CUDA tensor launches the
kernels or raises — there is no fallback.  The kernels take q in bf16 or
fp32 (any layout whose last dim is contiguous) and pools either in q's
dtype or quantized (int8 or fp8 e4m3 "fn" payloads with fp32 (P, Hkv)
``scales_k``/``scales_v``); head_dim 64 or 128; page_size a multiple of
16 up to 256; GQA group G <= 8; top_k up to :data:`MAX_TOP_K`; any
number of pages per sequence; ``kv_len`` int32 or int64; optional
per-head budgets ``head_top_k`` (adaptive routing), a contiguous
(Hkv, G) int32 tensor on q's card that the route kernel applies to each
head's score-sorted list (its values, in [1, top_k], are checked once
where the routing profile is validated, not per call: that would need
a host sync).

The plain pieces beside the kernels: :func:`union_pages` and
:func:`decode_tables` (the route tables from ``moba_paged_route``);
:func:`route_tables_plain` (the route kernel's own arithmetic: chunked
running top-k merged by rank, the union by rank); and
:func:`decode_partials_plain` / :func:`merge_partials_plain` (the
attention and merge kernels' partials and their merge).

``LAUNCHES`` counts decode calls that launched the kernels (one per MoBA
layer per step); ``KERNEL_LAUNCHES`` counts the kernels launched (three
per call).  :func:`launch` also returns the route tables the call wrote,
so a check can read the selections the attention used.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import MoBAConfig
from repro_torch.core import quantization as Q
from repro_torch.core import routing
from repro_torch.core.moba import (NEG_INF, moba_paged_decode_attention,
                                   paged_route_scores)
from repro_torch.kernels import runtime

LAUNCHES = 0
KERNEL_LAUNCHES = 0

GRIDS = ("grouped", "flat")
_HEAD_DIMS = (64, 128)
_MAX_PAGE = 256
_MAX_GROUP = 8
# the route kernel's lists and union tables take 7 words a slot of
# dynamic shared memory, G·min(top_k, npg) slots: 112 KB at G 8, top_k 512
MAX_TOP_K = 512
ROUTE_CHUNK = 128      # pages the route kernel scores per step
_TILE_BYTES = 16384    # K (and V) bytes one attention CTA stages at most
_MAX_CHUNK = 128       # tokens one attention CTA attends at most
_MAX_ROWS = 65535      # B * Hkv: the attention grid's y dimension


def route_smem_bytes(g: int, top_k: int, npg: int, d: int) -> Tuple[int, int]:
    """Shared memory of one route CTA, as ``csrc/moba_decode.cu`` sizes it:
    (static, dynamic) bytes.  Static: q and a chunk's masked scores for
    ``_MAX_GROUP`` heads (fp32); dynamic: 7 words a live slot,
    ``G·min(top_k, npg)`` slots.  Past 48 KB together the launch needs the
    attribute request the kernel always makes."""
    static = 4 * _MAX_GROUP * (d + ROUTE_CHUNK)
    return static, 4 * 7 * g * min(top_k, npg)


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
                   scales_v: Optional[torch.Tensor] = None, *,
                   centroids: Optional[torch.Tensor] = None,
                   block_table: Optional[torch.Tensor] = None,
                   kv_len: Optional[torch.Tensor] = None,
                   top_k: Optional[int] = None,
                   head_top_k: Optional[torch.Tensor] = None) -> None:
    """Raise a shaped error for inputs the CUDA kernels do not take (the
    routing inputs are checked when given)."""
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
    if any(t.data_ptr() % 16 for t in (pages_k, pages_v, centroids)
           if t is not None):
        problems.append("pools and centroids at 16-byte aligned addresses")
    if b < 1 or b * hkv > _MAX_ROWS:
        problems.append(f"1..{_MAX_ROWS} (batch, kv head) rows (got "
                        f"{b * hkv})")
    if centroids is not None and (
            centroids.dtype != torch.float32
            or tuple(centroids.shape) != (num_pages, hkv, d)
            or not centroids.is_contiguous()):
        problems.append(f"contiguous fp32 centroids {(num_pages, hkv, d)} "
                        f"(got {tuple(centroids.shape)}, {centroids.dtype})")
    if block_table is not None and (
            block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != b or block_table.shape[1] < 1
            or not block_table.is_contiguous()):
        problems.append(f"a contiguous int32 (B={b}, npg >= 1) block table "
                        f"(got {tuple(block_table.shape)}, "
                        f"{block_table.dtype})")
    if kv_len is not None and (
            kv_len.dtype not in (torch.int32, torch.int64)
            or tuple(kv_len.shape) != (b,) or not kv_len.is_contiguous()):
        problems.append(f"kv_len as contiguous int32 or int64 ({b},) (got "
                        f"{tuple(kv_len.shape)}, {kv_len.dtype})")
    if head_top_k is not None and (
            head_top_k.dtype != torch.int32
            or tuple(head_top_k.shape) != (hkv, h // hkv)
            or not head_top_k.is_contiguous()
            or head_top_k.device != q.device):
        problems.append(f"head_top_k as contiguous int32 (Hkv, G) = "
                        f"{(hkv, h // hkv)} on {q.device} (got "
                        f"{tuple(head_top_k.shape)}, {head_top_k.dtype}, "
                        f"{head_top_k.device})")
    if top_k is not None and not 1 <= top_k <= MAX_TOP_K:
        problems.append(f"top_k in 1..{MAX_TOP_K}, the limit the route "
                        f"kernel's shared memory sets at G <= {_MAX_GROUP} "
                        f"(got {top_k})")
    if problems:
        raise ValueError(
            f"moba_paged_decode CUDA kernel needs "
            f"{'; '.join(problems)} — q {tuple(q.shape)}, pool "
            f"{tuple(pages_k.shape)}")


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


class RouteTables(NamedTuple):
    """What the route kernel writes, per (batch, kv head) row."""

    sel: torch.Tensor     # (B·Hkv, G, top_k) int32 pages, -1 = invalid
    phys: torch.Tensor    # (B·Hkv, U) int32 physical page of union slot
    base: torch.Tensor    # (B·Hkv, G, U) int32 token base, npg·ps = none
    n_uniq: torch.Tensor  # (B·Hkv,) int32 union size


class Plan(NamedTuple):
    """Grids and scratch of one decode call (plain Python, from shapes).

    The route and merge kernels run one CTA per row; the attention
    kernel a (slots, rows) grid, slot x = union slot x // n_chunks,
    token chunk x % n_chunks.  A head fills at most ``min(top_k, npg)``
    slots, so the union holds at most ``min(G·min(top_k, npg), npg) =
    min(G·top_k, npg)`` pages and the grid stops there; the route
    kernel sizes its shared lists from the same ``G·min(top_k, npg)``."""

    rows: int       # B·Hkv
    g: int
    top_k: int
    u_cap: int      # G·top_k: width of the union tables
    u_grid: int     # union slots the attention grid covers
    chunk: int      # tokens per attention CTA
    n_chunks: int   # chunks per page
    slots: int      # partials per (row, head): u_grid·n_chunks
    d: int

    @property
    def int_sizes(self) -> Tuple[int, int, int, int]:
        """Elements of sel, phys, base and n_uniq, in that order."""
        r = self.rows
        return (r * self.g * self.top_k, r * self.u_cap,
                r * self.g * self.u_cap, r)

    @property
    def float_sizes(self) -> Tuple[int, int]:
        """Elements of the partial outputs and of their (m, l) pairs."""
        n = self.rows * self.slots * self.g
        return n * self.d, n * 2


def plan(b: int, h: int, hkv: int, top_k: int, npg: int, ps: int, d: int,
         itemsize: int) -> Plan:
    """The decode call's grids and scratch sizes for a pool of
    ``itemsize``-byte values.  A chunk is as many K rows as fit in
    ``_TILE_BYTES``, at most ``_MAX_CHUNK`` and never more than a page
    (the kernel's ``chunk_tokens<P, D>()`` bounds its tile the same
    way)."""
    g = h // hkv
    u_cap = g * top_k
    u_grid = min(u_cap, npg)
    chunk = min(ps, _MAX_CHUNK, _TILE_BYTES // (d * itemsize))
    n_chunks = -(-ps // chunk)
    return Plan(rows=b * hkv, g=g, top_k=top_k, u_cap=u_cap, u_grid=u_grid,
                chunk=chunk, n_chunks=n_chunks, slots=u_grid * n_chunks, d=d)


def route_tables_plain(q: torch.Tensor, centroids: torch.Tensor,
                       block_table: torch.Tensor, kv_len: torch.Tensor,
                       top_k: int, page_size: int,
                       head_top_k: Optional[torch.Tensor] = None
                       ) -> RouteTables:
    """The route kernel's arithmetic in PyTorch, returning exactly its
    outputs: the masked scores of ``moba_paged_route``
    (``paged_route_scores``); a running top-k over
    chunks of :data:`ROUTE_CHUNK` pages where each candidate's new place
    is the number of candidates that beat it (higher score on
    ``routing.order_key``'s total order, or equal score and lower page);
    selections scoring <= -5e29, or ranked at or
    past the head's budget (``head_top_k``, (Hkv, G)), invalid; the
    union by rank (a page's slot is the number of distinct selected
    pages below it); ``phys``/``base``/``n_uniq`` as
    :func:`decode_tables`."""
    b, h, _, _ = q.shape
    num_pages, hkv, _ = centroids.shape
    npg = block_table.shape[1]
    ps = page_size
    g = h // hkv
    dev = q.device
    pages = torch.arange(npg, device=dev)
    tbl = block_table.long()
    masked = paged_route_scores(q, centroids, block_table, kv_len,
                                ps)[..., 0, :]               # (B,Hkv,G,npg)
    top_s = masked[..., :0]
    top_i = pages[None, None, None, :0].expand(b, hkv, g, 0)
    for c0 in range(0, npg, ROUTE_CHUNK):
        cs = torch.cat([top_s, masked[..., c0:c0 + ROUTE_CHUNK]], -1)
        ci = torch.cat([top_i, pages[c0:c0 + ROUTE_CHUNK].expand(
            b, hkv, g, -1)], -1)
        key = routing.order_key(cs)
        sj, si = key[..., :, None], key[..., None, :]
        beats = (sj > si) | ((sj == si)
                             & (ci[..., :, None] < ci[..., None, :]))
        rank = beats.sum(-2)                                 # j beats i
        keep = min(top_k, cs.shape[-1])
        order = torch.argsort(rank, dim=-1)[..., :keep]
        top_s, top_i = cs.gather(-1, order), ci.gather(-1, order)
    filled = top_s.shape[-1]
    keep = top_s > NEG_INF / 2
    if head_top_k is not None:
        keep = keep & (torch.arange(filled, device=dev)
                       < head_top_k.to(dev)[..., None])
    sel = torch.where(keep, top_i, -1)
    ids = torch.cat([sel, sel.new_full((b, hkv, g, top_k - filled), -1)],
                    -1).reshape(b * hkv, g * top_k)          # head-major
    u_cap = g * top_k
    earlier = torch.ones(u_cap, u_cap, dtype=torch.bool,
                         device=dev).tril(-1)                # j < e
    dup = ((ids[:, :, None] == ids[:, None, :]) & earlier).any(-1)
    first = (ids >= 0) & ~dup
    slot = (first[:, None, :] & (ids[:, None, :] < ids[:, :, None])).sum(-1)
    n_uniq = first.sum(-1)
    uni = torch.zeros(b * hkv, u_cap + 1, dtype=torch.long, device=dev)
    uni.scatter_(1, torch.where(first, slot, u_cap), ids.clamp(min=0))
    uni = uni[:, :u_cap]
    rows_b = torch.arange(b * hkv, device=dev) // hkv
    phys = tbl[rows_b[:, None], uni].clamp(0, num_pages - 1)
    head = torch.arange(u_cap, device=dev) // top_k
    base = torch.full((b * hkv, g * u_cap + 1), npg * ps, dtype=torch.long,
                      device=dev)
    base.scatter_(1, torch.where(ids >= 0, head * u_cap + slot,
                                 g * u_cap), ids * ps)
    i32 = torch.int32
    return RouteTables(ids.reshape(b * hkv, g, top_k).to(i32),
                       phys.to(i32),
                       base[:, :g * u_cap].reshape(b * hkv, g, u_cap).to(i32),
                       n_uniq.to(i32))


def decode_partials_plain(q: torch.Tensor, pages_k: torch.Tensor,
                          pages_v: torch.Tensor, kv_len: torch.Tensor,
                          tables: RouteTables, p: Plan,
                          scale: Optional[float] = None,
                          scales_k: Optional[torch.Tensor] = None,
                          scales_v: Optional[torch.Tensor] = None):
    """The attention kernel's partials in PyTorch: for every (row, slot
    x = u·n_chunks + c, head) the unnormalised output ``o`` (rows,
    slots, G, d), the running max ``m`` and the sum ``l`` (rows, slots,
    G) of token chunk c of union page u.  Head g sees token t of the
    page iff base[g, u] + t < kv_len.  Slots past n_uniq, and chunks no
    head may see, hold the empty partial (0, -1e30, 0)."""
    b, h, _, d = q.shape
    _, ps, hkv, _ = pages_k.shape
    g, ug, nc, ch = p.g, p.u_grid, p.n_chunks, p.chunk
    rows = b * hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dev = q.device
    qr = q[:, :, 0].reshape(rows, g, d).float()
    heads = (torch.arange(rows, device=dev) % hkv)[:, None]
    phys = tables.phys[:, :ug].long()                        # (rows,Ug)
    base = tables.base[:, :, :ug].long()                     # (rows,G,Ug)
    active = (torch.arange(ug, device=dev)[None]
              < tables.n_uniq[:, None])                      # (rows,Ug)
    kvl = kv_len.long().repeat_interleave(hkv)               # (rows,)

    def tiles(pool, scales):
        t = pool[phys, :, heads].float()                     # (rows,Ug,ps,d)
        if scales is not None:
            t = t * scales[phys, heads][..., None, None]
        t = torch.nn.functional.pad(t, (0, 0, 0, nc * ch - ps))
        return t.reshape(rows, ug, nc, ch, d)

    k, v = tiles(pages_k, scales_k), tiles(pages_v, scales_v)
    tok = torch.arange(nc * ch, device=dev)
    pos = base[..., None] + tok                              # (rows,G,Ug,T)
    seen = ((pos < kvl[:, None, None, None]) & (tok < ps)
            & active[:, None, :, None]).reshape(rows, g, ug, nc, ch)
    s = torch.einsum("rgd,ructd->rguct", qr, k) * scale
    s = torch.where(seen, s, NEG_INF)
    m = s.amax(-1)                                           # (rows,G,Ug,nc)
    e = torch.where(seen, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(-1)
    o = torch.einsum("rguct,ructd->rgucd", e, v)

    def by_slot(x):
        x = x.movedim(1, 3)                              # (rows,Ug,nc,G,..)
        return x.reshape(rows, ug * nc, *x.shape[3:])

    return by_slot(o), by_slot(m), by_slot(l)


def merge_partials_plain(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         n_uniq: torch.Tensor, p: Plan, b: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel in PyTorch: partials ``j < n_uniq·n_chunks`` of
    each row, weighted by exp(m_j - max m), summed in slot order;
    (B, H, 1, d) in ``dtype``, zeros where no token was visible."""
    rows, slots, g, d = o.shape
    live = (torch.arange(slots, device=o.device)[None]
            < (n_uniq.long() * p.n_chunks)[:, None])[..., None]
    live = live & (l > 0)                                    # (rows,S,G)
    mx = torch.where(live, m, NEG_INF).amax(1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    lsum = (w * l).sum(1)                                    # (rows,G)
    acc = (w[..., None] * o).sum(1)                          # (rows,G,d)
    out = torch.where(lsum[..., None] > 0,
                      acc / lsum.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(b, rows // b * g, 1, d).to(dtype)


_DECODE_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                    + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])


def launch(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
           centroids: torch.Tensor, block_table: torch.Tensor,
           kv_len: torch.Tensor, top_k: int, scale: float,
           scales_k: Optional[torch.Tensor] = None,
           scales_v: Optional[torch.Tensor] = None,
           head_top_k: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, RouteTables]:
    """The three launches (route, attend, merge) in one C call on checked
    CUDA inputs.  Returns the output and the route tables this call
    wrote (views of its scratch): the selections it attended to."""
    out, scratch, p = _launch(q, pages_k, pages_v, centroids, block_table,
                              kv_len, top_k, scale, scales_k, scales_v,
                              head_top_k)
    n_floats = sum(p.float_sizes)
    sel, phys, base, n_uniq = torch.split(scratch[n_floats:], p.int_sizes)
    return out, RouteTables(sel.view(p.rows, p.g, top_k),
                            phys.view(p.rows, p.u_cap),
                            base.view(p.rows, p.g, p.u_cap), n_uniq)


def _launch(q, pages_k, pages_v, centroids, block_table, kv_len, top_k,
            scale, scales_k, scales_v, head_top_k=None):
    """:func:`launch` without the tables' views (host time a call)."""
    global LAUNCHES, KERNEL_LAUNCHES
    if q.stride(-1) != 1:
        q = q.contiguous()
    b, h, _, d = q.shape
    num_pages, ps, hkv, _ = pages_k.shape
    npg = block_table.shape[1]
    p = plan(b, h, hkv, top_k, npg, ps, d, pages_k.element_size())
    n_o, n_ml = p.float_sizes
    # one buffer: the fp32 partials, then the int32 tables
    scratch = torch.empty(n_o + n_ml + sum(p.int_sizes), dtype=torch.int32,
                          device=q.device)
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    at = scratch.data_ptr()
    ints = [at + 4 * (n_o + n_ml)]
    for n in p.int_sizes[:-1]:
        ints.append(ints[-1] + 4 * n)
    ptr = runtime.ptr
    lib = runtime.bind("moba_decode", "moba_paged_decode", _DECODE_ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.moba_paged_decode(
            ptr(q), q.stride(0), q.stride(1), ptr(pages_k), ptr(pages_v),
            None if scales_k is None else ptr(scales_k),
            None if scales_v is None else ptr(scales_v), ptr(centroids),
            ptr(block_table), ptr(kv_len), int(kv_len.dtype == torch.int64),
            None if head_top_k is None else ptr(head_top_k), *ints, at, at + 4 * n_o, ptr(out), p.rows, hkv, p.g, top_k, npg,
            ps, d, num_pages, p.chunk, p.n_chunks, p.slots, float(scale),
            runtime.DTYPE_CODES[q.dtype],
            runtime.PAYLOAD_CODES[pages_k.dtype], runtime.stream_of(q))
    if err:
        runtime.check(err, f"moba_paged_decode (q {tuple(q.shape)}, pool "
                           f"{tuple(pages_k.shape)})")
    LAUNCHES += 1
    KERNEL_LAUNCHES += 3
    return out, scratch, p


def moba_paged_decode(q: torch.Tensor, pages_k: torch.Tensor,
                      pages_v: torch.Tensor, centroids: torch.Tensor,
                      block_table: torch.Tensor, kv_len: torch.Tensor,
                      cfg: MoBAConfig, scale: Optional[float] = None,
                      grid: str = "grouped",
                      scales_k: Optional[torch.Tensor] = None,
                      scales_v: Optional[torch.Tensor] = None,
                      head_top_k: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Drop-in for ``core.moba.moba_paged_decode_attention`` (same
    contract): q (B, H, 1, d); pages_k/v (P, page_size, Hkv, d);
    centroids (P, Hkv, d) fp32; block_table (B, npg) int32, -1 =
    unassigned; kv_len (B,) post-append lengths; scales_k/v (P, Hkv)
    fp32 for a quantized pool, else None.  Rows with ``kv_len`` 0
    return zeros on the card.

    ``head_top_k``: per-head budgets of an adaptive routing profile,
    (Hkv, G) int32 in [1, top_k] with query head h = hkv·G + g, or None
    for the static top_k.  Head h keeps the first ``head_top_k[hkv, g]``
    pages of its score-sorted selection (rank 0 is its own page), so the
    group's union, and the pages the attention reads, shrink with it.
    On the card the route kernel applies the budgets; the contiguous
    int32 (Hkv, G) layout and the device are checked per call, the
    values are not.

    ``grid`` keeps the reference's API ("grouped" | "flat"); on Hopper
    both reach the same kernels.
    """
    with tracing.span("kernel.moba_decode"):
        return _paged_decode(q, pages_k, pages_v, centroids, block_table,
                             kv_len, cfg, scale, grid, scales_k, scales_v,
                             head_top_k)


def _paged_decode(q, pages_k, pages_v, centroids, block_table, kv_len, cfg,
                  scale, grid, scales_k, scales_v, head_top_k):
    if grid not in GRIDS:
        raise ValueError(f"unknown decode grid {grid!r}: expected "
                         f"'grouped' or 'flat'")
    if q.device.type == "cpu":
        return moba_paged_decode_attention(q, pages_k, pages_v, centroids,
                                           block_table, kv_len, cfg,
                                           scale=scale, scales_k=scales_k,
                                           scales_v=scales_v,
                                           head_top_k=head_top_k)
    if q.device.type != "cuda":
        raise ValueError(f"moba_paged_decode: tensors on {q.device}; "
                         f"expected cpu (plain version) or cuda (kernel)")
    check_contract(q, pages_k, pages_v, scales_k, scales_v,
                   centroids=centroids, block_table=block_table,
                   kv_len=kv_len, top_k=cfg.top_k, head_top_k=head_top_k)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _launch(q, pages_k, pages_v, centroids, block_table, kv_len,
                   cfg.top_k, scale, scales_k, scales_v, head_top_k)[0]
