"""Banded causal flash attention (sliding window): the Hopper kernels'
wrappers, and the SWA layers' training attention.

Replaces ``repro.kernels.swa.swa_attention`` (the TPU's ``_swa_kernel``)
with the same API and layout: q (BH, N, d), k and v (BKV, N, d), BH =
batch·H, GQA by ``num_q_heads``/``group``.  The CUDA kernel is
``csrc/swa.cu``; its header says what bounds it on an H100 (bytes: q, k,
v read once, o written once) and what the design does about that.  In
bf16 both products run on the tensor cores over tiles of ``CTA_ROWS``
query rows, K/V in chunks of ``KEY_CHUNK[d]`` keys; :func:`band_chunks` is
the plain mirror of the chunks a CTA and each of its warps walk and of
which ones take a mask.  In fp32 a SIMT body walks the reference's
``q_tile``/``k_tile``.

Training: :class:`SWAAttention` differentiates it.  Its forward is the
bf16 kernel, which then also writes each row's log-sum-exp; its backward
is ``csrc/swa_bwd.cu`` (two passes: dQ and delta query-major over
:func:`band_chunks`, dK and dV key-major over :func:`band_slices`; no
atomics).  The flash backend runs the SWA layers' cache-free attention
through it (:func:`training_case` says which inputs; ``core/backends.py``),
so no (N, N) scores exist; every other SWA call keeps
``core/attention.py::dense_attention``.  The JAX package's SWA layers run
dense attention (its kernel is forward only).

Device contract: a CPU tensor takes the plain PyTorch version
(:func:`swa_attention_plain`, ``dense_attention`` with the window on the
regrouped tensors; in training also :func:`swa_lse_plain` and
:func:`swa_backward_plain`); a CUDA tensor launches the kernel or raises —
there is no fallback.  The kernel takes q, k and v of one dtype, bf16 or
fp32, contiguous and 16-byte aligned; head_dim 64 or 128; in fp32,
``q_tile`` a multiple of 32 with q_tile·d/64 <= 256 threads and BH <=
65535; in bf16, at most 65535 tiles of ``CTA_ROWS`` rows.  Both dtypes
keep the reference's check that ``q_tile`` and ``k_tile`` divide N.
Training takes bf16 only.

``LAUNCHES`` counts forward kernel launches (and nothing else);
``BWD_LAUNCHES`` counts backward calls, each launching the two passes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.core.attention import NEG_INF, dense_attention
from repro_torch.kernels import runtime

LAUNCHES = 0
BWD_LAUNCHES = 0

# the bf16 body's tile (``csrc/swa.cu``): 4 warps of 16 query rows
CTA_ROWS = 64
# keys a chunk of the bf16 body's K/V ring, by head_dim (``csrc/swa.cu``)
KEY_CHUNK = {64: 64, 128: 32}
WARP_ROWS = 16
# query rows a slice of the backward's key-major pass, by head_dim
# (``csrc/swa_bwd.cu``)
ROW_SLICE = {64: 64, 128: 32}
_MAX_TILES = 65535             # gridDim.y
_HEAD_DIMS = (64, 128)
_MAX_THREADS = 256
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_void_p])


def band_chunks(n: int, window: int, rows: int, kc: int, r0: int):
    """The chunks of ``kc`` keys that query rows ``r0 .. r0 + rows - 1``
    (those below n) meet, as ``(c0, masked)`` in order: the plain mirror
    of ``csrc/swa.cu``'s bf16 body, which walks a CTA's chunks (rows =
    its tile) and, among them, each warp's own (rows = 16), and masks a
    chunk unless it lies inside every row's band."""
    last = min(r0 + rows, n) - 1
    if last < r0:
        return []
    first = max(r0 - window + 1, 0) // kc * kc
    return [(c0, not (c0 + kc - 1 <= r0 and last - c0 < window))
            for c0 in range(first, last + 1, kc)]


def band_slices(n: int, window: int, keys: int, r: int, k0: int):
    """The slices of ``r`` query rows (starting at multiples of r) that
    keys ``k0 .. k0 + keys - 1`` meet, as ``(s0, masked)`` in order: the
    plain mirror of ``csrc/swa_bwd.cu``'s key-major pass, which walks a
    CTA's slices (keys = its ``CTA_ROWS``, k0 a multiple of them) and,
    among them, each warp's own (keys = 16), and masks a slice unless its
    every row lies inside every key's band and below n.  A window above n
    is the window n."""
    if min(k0 + keys, n) <= k0:
        return []
    window = min(window, n)
    last = min(k0 + keys - 1 + window - 1, n - 1)
    return [(s0, not (s0 >= k0 + keys - 1 and s0 + r - 1 <= k0 + window - 1
                      and s0 + r <= n))
            for s0 in range(k0 // r * r, last + 1, r)]


def _tiles(n: int, q_tile: int, k_tile: int):
    """The reference's tiles, ``min(tile, n)``, which must divide n."""
    q_tile, k_tile = min(q_tile, n), min(k_tile, n)
    if q_tile < 1 or k_tile < 1 or n % q_tile or n % k_tile:
        raise ValueError(f"swa_attention needs q_tile and k_tile that "
                         f"divide N (got N={n}, q_tile={q_tile}, "
                         f"k_tile={k_tile})")
    return q_tile, k_tile


def _heads(bh: int, bkv: int, num_q_heads: int, group: int):
    """(H, batch) of the reference's row map; raise if BH, BKV, H and
    the group do not fit it."""
    h = num_q_heads or bh
    if group < 1 or h % group or bh % h or bkv != (bh // h) * (h // group):
        raise ValueError(f"swa_attention needs BH = batch·H and BKV = "
                         f"batch·H/group (got BH={bh}, BKV={bkv}, "
                         f"H={h}, group={group})")
    return h, bh // h


def swa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int, *, num_q_heads: int = 0,
                        group: int = 1,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: ``dense_attention(causal=True, window=window)``
    on (batch, H, N, d) / (batch, H/group, N, d) views."""
    bh, n, d = q.shape
    h, batch = _heads(bh, k.shape[0], num_q_heads, group)
    o = dense_attention(q.reshape(batch, h, n, d),
                        k.reshape(batch, h // group, n, d),
                        v.reshape(batch, h // group, n, d), causal=True,
                        window=window, scale=scale)
    return o.reshape(bh, n, d)


def _grouped(q: torch.Tensor, k: torch.Tensor, num_q_heads: int,
             group: int):
    """q (BH, N, d) and k (BKV, N, d) as fp32 (batch, Hkv, group, N, d)
    and (batch, Hkv, N, d) views."""
    bh, n, d = q.shape
    h, batch = _heads(bh, k.shape[0], num_q_heads, group)
    return (q.float().reshape(batch, h // group, group, n, d),
            k.float().reshape(batch, h // group, n, d))


def _band(n: int, window: int, device) -> torch.Tensor:
    pos = torch.arange(n, device=device)
    return (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)


def swa_lse_plain(q: torch.Tensor, k: torch.Tensor, window: int, *,
                  num_q_heads: int = 0, group: int = 1,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Each query row's log-sum-exp (natural log, fp32, (BH, N)) of its
    scaled scores over its band: what the bf16 kernel writes."""
    bh, n, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qg, kg = _grouped(q, k, num_q_heads or bh, group)
    s = torch.einsum("bhgqd,bhsd->bhgqs", qg, kg) * scale
    s = torch.where(_band(n, window, q.device), s, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(bh, n)


def swa_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       window: int, *, num_q_heads: int = 0, group: int = 1,
                       scale: Optional[float] = None):
    """The plain version of the backward kernel: (dq, dk, dv) in q's, k's
    and v's dtypes, from P = exp(S - lse) over the band, delta =
    rowsum(dO ∘ o), dS = P (dP - delta), all in fp32."""
    bh, n, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qg, kg = _grouped(q, k, num_q_heads or bh, group)
    shape = qg.shape
    vg = v.float().reshape(kg.shape)
    dog = do.float().reshape(shape)
    s = torch.einsum("bhgqd,bhsd->bhgqs", qg, kg) * scale
    p = torch.where(_band(n, window, q.device),
                    torch.exp(s - lse.reshape(shape[:-1])[..., None]), 0.0)
    delta = (dog * o.float().reshape(shape)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhgqd,bhsd->bhgqs", dog, vg) - delta)
    dq = torch.einsum("bhgqs,bhsd->bhgqd", ds, kg) * scale
    dk = torch.einsum("bhgqs,bhgqd->bhsd", ds, qg) * scale
    dv = torch.einsum("bhgqs,bhgqd->bhsd", p, dog)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def check_contract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_tile: int, k_tile: int) -> None:
    """Raise a shaped error for inputs the CUDA kernel does not take: the
    bf16 body's over its own tiles, the fp32 body's over the reference's
    ``q_tile``."""
    bh, n, d = q.shape
    problems = []
    if q.dtype not in runtime.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        problems.append(f"q, k and v of one dtype, bf16 or fp32 (got "
                        f"{q.dtype}/{k.dtype}/{v.dtype})")
    if d not in _HEAD_DIMS:
        problems.append(f"head_dim in {_HEAD_DIMS} (got {d})")
    elif q.dtype == torch.bfloat16:
        if -(-n // CTA_ROWS) > _MAX_TILES:
            problems.append(f"at most {_MAX_TILES} tiles of {CTA_ROWS} "
                            f"rows (got N={n})")
    elif q_tile % 32 or q_tile * d // 64 > _MAX_THREADS:
        problems.append(f"q_tile a multiple of 32 with q_tile·d/64 <= "
                        f"{_MAX_THREADS} (got q_tile={q_tile}, d={d})")
    if q.dtype != torch.bfloat16 and not 1 <= bh <= 65535:
        problems.append(f"1..65535 query rows (got {bh})")
    if k.shape != v.shape or k.shape[1:] != (n, d):
        problems.append(f"k and v of shape (BKV, N, d) (got "
                        f"{tuple(k.shape)}/{tuple(v.shape)})")
    if not all(t.is_contiguous() for t in (q, k, v)):
        problems.append("contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        problems.append("16-byte aligned q, k and v")
    if problems:
        raise ValueError(
            f"swa_attention CUDA kernel needs {'; '.join(problems)} — q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}")


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, *, num_q_heads: int = 0, group: int = 1,
                  scale: Optional[float] = None, q_tile: int = 128,
                  k_tile: int = 128) -> torch.Tensor:
    """q: (BH, N, d); k, v: (BKV, N, d); BH = batch·H, BKV = batch·Hkv.
    Query i attends keys j with ``i - window < j <= i``; the output is in
    q's dtype."""
    bh, n, d = q.shape
    if window < 1:
        raise ValueError(f"swa_attention needs window >= 1 (got {window})")
    q_tile, k_tile = _tiles(n, q_tile, k_tile)
    h, _ = _heads(bh, k.shape[0], num_q_heads, group)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, window, num_q_heads=h,
                                   group=group, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention: tensors on {q.device}; expected "
                         f"cpu (plain version) or cuda (kernel)")
    check_contract(q, k, v, q_tile, k_tile)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    return launch(q, k, v, window, h, group, scale, q_tile, k_tile)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           num_q_heads: int, group: int, scale: float, q_tile: int,
           k_tile: int, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the CUDA kernel on checked tensors (``q_tile`` and
    ``k_tile`` reach only the fp32 body); the bf16 body also writes each
    row's log-sum-exp into ``lse`` ((BH, N) fp32) when one is given."""
    global LAUNCHES
    bh, n, d = q.shape
    out = torch.empty_like(q)
    ptr = runtime.ptr
    lib = runtime.bind("swa", "swa_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.swa_attention(ptr(q), ptr(k), ptr(v), ptr(out),
                                None if lse is None else ptr(lse), bh, n, d,
                                num_q_heads, group, window, q_tile, k_tile,
                                float(scale), runtime.DTYPE_CODES[q.dtype],
                                runtime.stream_of(q))
    runtime.check(err, f"swa_attention (q {tuple(q.shape)}, k "
                       f"{tuple(k.shape)}, window {window})")
    LAUNCHES += 1
    return out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
               window: int, num_q_heads: int, group: int, scale: float):
    """One call of the backward kernel's two passes on checked bf16
    tensors (q, o, dO (BH, N, d); k, v (BKV, N, d); lse (BH, N) fp32):
    (dq, dk, dv) in bf16."""
    global BWD_LAUNCHES
    bh, n, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    ptr = runtime.ptr
    lib = runtime.bind("swa_bwd", "swa_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.swa_attention_bwd(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(delta),
            ptr(dq), ptr(dk), ptr(dv), bh, n, d, num_q_heads, group, window,
            float(scale), runtime.stream_of(q))
    runtime.check(err, f"swa_attention_bwd (q {tuple(q.shape)}, k "
                       f"{tuple(k.shape)}, window {window})")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def training_case(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_positions=None, kv_len=None) -> bool:
    """Whether attention inputs q (B, H, Nq, d), k and v (B, Hkv, Nk, d)
    are the case :class:`SWAAttention` takes: a causal sequence attending
    its own keys (no ``kv_len``, no ``q_positions``, Nq == Nk) in bf16 at
    head_dim 64 or 128, on any device."""
    return (causal and kv_len is None and q_positions is None
            and q.shape[2] == k.shape[2] and q.shape[-1] in _HEAD_DIMS
            and q.dtype == k.dtype == v.dtype == torch.bfloat16)


class SWAAttention(torch.autograd.Function):
    """Banded attention on (BH, N, d) / (BKV, N, d) tensors with a
    backward: on CUDA the bf16 kernel (with the log-sum-exp) forward and
    the backward kernel; on the CPU the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, num_q_heads: int, group: int,
                scale: float):
        with tracing.span("kernel.swa"):
            if q.device.type == "cuda":
                if q.dtype != torch.bfloat16:
                    raise ValueError(f"SWAAttention's kernels take bf16 (got "
                                     f"{q.dtype})")
                check_contract(q, k, v, 128, 128)
                lse = torch.empty(q.shape[:2], dtype=torch.float32,
                                  device=q.device)
                o = launch(q, k, v, window, num_q_heads, group, scale, 128,
                           128, lse=lse)
            else:
                kw = dict(num_q_heads=num_q_heads, group=group, scale=scale)
                o = swa_attention_plain(q, k, v, window, **kw)
                lse = swa_lse_plain(q, k, window, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.meta = (window, num_q_heads, group, scale)
            return o

    @staticmethod
    def backward(ctx, do):
        with tracing.span("kernel.swa_bwd"):
            q, k, v, o, lse = ctx.saved_tensors
            window, h, group, scale = ctx.meta
            do = do.contiguous()
            if q.device.type == "cuda":
                check_contract(q, do, o, 128, 128)
                dq, dk, dv = launch_bwd(q, k, v, o, lse, do, window, h, group,
                                        scale)
            else:
                dq, dk, dv = swa_backward_plain(
                    q, k, v, o, lse, do, window, num_q_heads=h, group=group,
                    scale=scale)
            return dq, dk, dv, None, None, None, None


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """Differentiable causal sliding-window attention on q (B, H, N, d),
    k, v (B, Hkv, N, d) through :class:`SWAAttention`; the output is (B,
    H, N, d) in q's dtype."""
    b, h, n, d = q.shape
    hkv = k.shape[1]
    if window < 1:
        raise ValueError(f"banded_attention needs window >= 1 (got "
                         f"{window})")
    scale = d ** -0.5 if scale is None else float(scale)
    o = SWAAttention.apply(q.reshape(b * h, n, d).contiguous(),
                           k.reshape(b * hkv, n, d).contiguous(),
                           v.reshape(b * hkv, n, d).contiguous(), window, h,
                           h // hkv, scale)
    return o.reshape(b, h, n, d)
