"""Flash TopK: the Hopper kernel's wrapper.

Replaces ``repro.kernels.flash_topk.flash_topk`` (the TPU's grouped and
flat grids).  The CUDA kernel is ``csrc/flash_topk.cu``; its header says
what bounds it on an H100 (bytes: q read once, the (Nq, nb) scores never
stored) and what the design does about that (one CTA per GQA group and
q tile, the running top-k in registers).

Selections follow ``core/routing.py::select_blocks`` exactly: future
blocks -1e30, the own block +1e30, sentinel ``nb`` for slots at or below
-5e29, ties to the lower block id.

Device contract: a CPU tensor takes the plain PyTorch version
(``kernels/ref.py::flash_topk_ref``); a CUDA tensor launches the kernel
or raises — there is no fallback.  The kernel takes q and centroids of
one dtype, bf16 or fp32, head_dim 64 or 128 and ``top_k`` up to 16.
``grid`` ("grouped" | "flat") and ``cent_tile`` keep the reference's
API; both grids reach the one kernel, which stages its own tile.

``LAUNCHES`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, runtime

LAUNCHES = 0

GRIDS = ("grouped", "flat")
_HEAD_DIMS = (64, 128)
_MAX_TOP_K = 16
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
             + [ctypes.c_void_p])


def check_contract(q: torch.Tensor, centroids: torch.Tensor, top_k: int,
                   group: int, num_q_heads: int, q_pos_offset: int) -> None:
    """Raise a shaped error for inputs the CUDA kernel does not take."""
    bh, nq, d = q.shape
    bkv = centroids.shape[0]
    problems = []
    if q.dtype not in runtime.DTYPE_CODES or centroids.dtype != q.dtype:
        problems.append(f"q and centroids of one dtype, bf16 or fp32 (got "
                        f"{q.dtype}/{centroids.dtype})")
    if d not in _HEAD_DIMS or centroids.shape[-1] != d:
        problems.append(f"head_dim in {_HEAD_DIMS} (got {d}/"
                        f"{centroids.shape[-1]})")
    if not 1 <= top_k <= _MAX_TOP_K:
        problems.append(f"top_k in 1..{_MAX_TOP_K} (got {top_k})")
    if num_q_heads % group or bh != bkv * group:
        problems.append(f"BH = BKV·G with G | H (got BH={bh}, BKV={bkv}, "
                        f"G={group}, H={num_q_heads})")
    if not 1 <= bkv <= 65535:
        problems.append(f"1..65535 kv rows (got {bkv})")
    if q_pos_offset < 0:
        problems.append(f"queries that are a suffix of the keys "
                        f"(q_pos_offset {q_pos_offset})")
    if problems:
        raise ValueError(f"flash_topk CUDA kernel needs "
                         f"{'; '.join(problems)} — q {tuple(q.shape)}, "
                         f"centroids {tuple(centroids.shape)}")


def flash_topk(q: torch.Tensor, centroids: torch.Tensor, top_k: int,
               block_size: int, *, group: int = 1, num_q_heads: int = 0,
               causal: bool = True, q_pos_offset: int = 0,
               q_tile: int = 128, cent_tile: int = 128,
               grid: str = "grouped") -> torch.Tensor:
    """q: (BH, Nq, d); centroids: (BKV, nb, d) with BH = batch·H,
    BKV = batch·Hkv, H = Hkv·group (``num_q_heads`` = H, default BH).
    Returns (BH, Nq, top_k) int32 selected block ids (sentinel nb)."""
    if grid not in GRIDS:
        raise ValueError(f"unknown topk grid {grid!r}: expected 'grouped' "
                         f"or 'flat'")
    h = num_q_heads or q.shape[0]
    if q.device.type == "cpu":
        return ref.flash_topk_ref(q, centroids, top_k, block_size,
                                  group=group, num_q_heads=h, causal=causal,
                                  q_pos_offset=q_pos_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_topk: tensors on {q.device}; expected cpu "
                         f"(plain version) or cuda (kernel)")
    check_contract(q, centroids, top_k, group, h, q_pos_offset)
    return launch(q.contiguous(), centroids.contiguous(), top_k, block_size,
                  group=group, causal=causal, q_pos_offset=q_pos_offset,
                  q_tile=q_tile)


def launch(q: torch.Tensor, centroids: torch.Tensor, top_k: int,
           block_size: int, *, group: int, causal: bool, q_pos_offset: int,
           q_tile: int) -> torch.Tensor:
    """One launch of the CUDA kernel on contiguous, checked inputs."""
    global LAUNCHES
    bh, nq, d = q.shape
    bkv, nb, _ = centroids.shape
    q_tile = min(q_tile, nq)
    out = torch.empty((bh, nq, top_k), dtype=torch.int32, device=q.device)
    lib = runtime.bind("flash_topk", "flash_topk", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.flash_topk(runtime.ptr(q), runtime.ptr(centroids),
                             runtime.ptr(out), bkv, nq, nb, d, top_k,
                             block_size, group, q_tile, int(causal),
                             q_pos_offset, runtime.DTYPE_CODES[q.dtype],
                             runtime.stream_of(q))
    runtime.check(err, f"flash_topk (q {tuple(q.shape)}, centroids "
                       f"{tuple(centroids.shape)})")
    LAUNCHES += 1
    return out
