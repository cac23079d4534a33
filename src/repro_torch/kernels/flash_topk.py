"""Flash TopK: the Hopper kernel's wrapper.

Replaces ``repro.kernels.flash_topk.flash_topk`` (the TPU's grouped and
flat grids).  The CUDA kernel is ``csrc/flash_topk.cu``; its header says
what bounds it on an H100 (bytes: q read once, the (Nq, nb) scores never
stored) and what the design does about that: one CTA covers the G heads
of a GQA group for a run of queries, bf16 scores on the tensor cores
(fp32 on a SIMT body), and one thread a row keeps the running top-k,
filtering each candidate against the row's k-th score and merging the
survivors by rank (in registers up to top_k 32, in shared memory above).

Selections follow ``core/routing.py::select_blocks`` exactly: future
blocks -1e30, the own block +1e30, sentinel ``nb`` for slots at or below
-5e29, ties to the lower block id.

Device contract: a CPU tensor takes the plain PyTorch version
(``kernels/ref.py::flash_topk_ref``); a CUDA tensor launches the kernel
or raises — there is no fallback.  The kernel takes q and centroids of
one dtype, bf16 or fp32, 16-byte aligned, head_dim 64 or 128 (or latent
attention's 192 at ``top_k`` up to 32), ``top_k``
up to :data:`MAX_TOP_K` (the rows a CTA covers shrink as ``top_k`` grows
so the shared-memory lists fit: :func:`rows_per_cta`) and a GQA group of
at most that many rows.  ``top_k`` at or above nb gives every valid
block, then sentinels.  ``grid`` ("grouped" | "flat"), ``q_tile`` and
``cent_tile`` keep the reference's API; both grids reach the one kernel,
which picks its own rows and centroid tile.

``LAUNCHES`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, runtime

LAUNCHES = 0

GRIDS = ("grouped", "flat")
_HEAD_DIMS = (64, 128, 192)
MAX_TOP_K = 1024      # 16 rows a CTA with 128 KB of lists
_REG_MAX_K = 32       # register lists up to this top_k, 128 rows a CTA
_LIST_BYTES = 131072
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])


def rows_per_cta(top_k: int) -> int:
    """Rows (heads x queries) one CTA covers: 128, or for shared-memory
    lists (top_k > 32) ``16·floor(1024 / top_k)`` when that is fewer (the
    kernel's ``rows_for``)."""
    if top_k <= _REG_MAX_K:
        return 128
    return min(128, 16 * (_LIST_BYTES // (8 * 16 * top_k)))


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
    elif d == 192 and top_k > _REG_MAX_K:
        problems.append(f"at head_dim 192 a top_k of at most {_REG_MAX_K}, "
                        f"the register lists (got {top_k})")
    if not 1 <= top_k <= MAX_TOP_K:
        problems.append(f"top_k in 1..{MAX_TOP_K}, the limit the "
                        f"shared-memory lists of 16 rows set (got {top_k})")
    elif group > rows_per_cta(top_k):
        problems.append(f"a GQA group of at most {rows_per_cta(top_k)} "
                        f"heads at top_k {top_k} (got {group})")
    if num_q_heads % group or bh != bkv * group:
        problems.append(f"BH = BKV·G with G | H (got BH={bh}, BKV={bkv}, "
                        f"G={group}, H={num_q_heads})")
    if not 1 <= bkv <= 65535:
        problems.append(f"1..65535 kv rows (got {bkv})")
    if any(t.data_ptr() % 16 for t in (q, centroids)):
        problems.append("16-byte aligned q and centroids")
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
                  group=group, causal=causal, q_pos_offset=q_pos_offset)


def launch(q: torch.Tensor, centroids: torch.Tensor, top_k: int,
           block_size: int, *, group: int, causal: bool,
           q_pos_offset: int) -> torch.Tensor:
    """One launch of the CUDA kernel on contiguous, checked inputs."""
    global LAUNCHES
    bh, nq, d = q.shape
    bkv, nb, _ = centroids.shape
    out = torch.empty((bh, nq, top_k), dtype=torch.int32, device=q.device)
    lib = runtime.bind("flash_topk", "flash_topk", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = lib.flash_topk(runtime.ptr(q), runtime.ptr(centroids),
                             runtime.ptr(out), bkv, nq, nb, d, top_k,
                             block_size, group, int(causal),
                             q_pos_offset, runtime.DTYPE_CODES[q.dtype],
                             runtime.stream_of(q))
    runtime.check(err, f"flash_topk (q {tuple(q.shape)}, centroids "
                       f"{tuple(centroids.shape)})")
    LAUNCHES += 1
    return out
