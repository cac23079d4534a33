"""Banded causal flash attention (sliding window): the Hopper kernel's
wrapper.

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

No serving or training path calls it, in either package: the SWA layers
run ``core/attention.py::dense_attention``.

Device contract: a CPU tensor takes the plain PyTorch version
(:func:`swa_attention_plain`, ``dense_attention`` with the window on the
regrouped tensors); a CUDA tensor launches the kernel or raises — there
is no fallback.  The kernel takes q, k and v of one dtype, bf16 or fp32,
contiguous and 16-byte aligned; head_dim 64 or 128; in fp32, ``q_tile``
a multiple of 32 with q_tile·d/64 <= 256 threads and BH <= 65535; in
bf16, at most 65535 tiles of ``CTA_ROWS`` rows.  Both dtypes keep the
reference's check that ``q_tile`` and ``k_tile`` divide N.

``LAUNCHES`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.attention import dense_attention
from repro_torch.kernels import runtime

LAUNCHES = 0

# the bf16 body's tile (``csrc/swa.cu``): 4 warps of 16 query rows
CTA_ROWS = 64
# keys a chunk of the bf16 body's K/V ring, by head_dim (``csrc/swa.cu``)
KEY_CHUNK = {64: 64, 128: 32}
WARP_ROWS = 16
_MAX_TILES = 65535             # gridDim.y
_HEAD_DIMS = (64, 128)
_MAX_THREADS = 256
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


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
           k_tile: int) -> torch.Tensor:
    """One launch of the CUDA kernel on checked tensors (``q_tile`` and
    ``k_tile`` reach only the fp32 body)."""
    global LAUNCHES
    bh, n, d = q.shape
    out = torch.empty_like(q)
    ptr = runtime.ptr
    lib = runtime.bind("swa", "swa_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.swa_attention(ptr(q), ptr(k), ptr(v), ptr(out), bh, n, d,
                                num_q_heads, group, window, q_tile, k_tile,
                                float(scale), runtime.DTYPE_CODES[q.dtype],
                                runtime.stream_of(q))
    runtime.check(err, f"swa_attention (q {tuple(q.shape)}, k "
                       f"{tuple(k.shape)}, window {window})")
    LAUNCHES += 1
    return out
