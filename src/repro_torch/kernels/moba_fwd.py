"""FlashMoBA forward: the Hopper kernel's wrapper.

Replaces ``repro.kernels.moba_fwd.moba_fwd`` (the TPU's kb-tiled and flat
grids).  The CUDA kernel is ``csrc/moba_fwd.cu``; its header says what
bounds it on an H100 (bytes: q_sorted and the fp32 partials live in
device memory) and what the design does about that.  bf16 runs on the
tensor cores: one CTA of 8 warps a q tile stages the tile's Q and the
key block's K/V in shared memory with asynchronous copies (the whole
block up to 256 keys, a two-chunk ring above), and each warp runs Q Kᵀ,
the online softmax and P V for 16 query rows in registers.  fp32 keeps a SIMT body that streams K/V in ``kb_tile``
chunks (TF32 would break the fp32 tolerances).

Device contract: a CPU tensor takes the plain PyTorch version
(``kernels/ref.py::moba_partials_ref``); a CUDA tensor launches the
kernel or raises — there is no fallback.  The kernel takes q_sorted and
K/V blocks of one dtype, bf16 or fp32; head_dim 64 or 128; a q tile of
at most 128 rows; ``kb_tile`` a multiple of 16 up to 128 that divides
the block size (the reference's rule: the fp32 body streams K/V in
``kb_tile`` chunks, and in bf16 it makes the block any multiple of 16
keys that ``kb_tile`` divides: 512 and 1024 included).  ``grid`` keeps the reference's API; both grids
reach the one kernel.

``LAUNCHES`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref, runtime

LAUNCHES = 0

GRIDS = ("grouped", "flat")
_HEAD_DIMS = (64, 128)
_MAX_Q_TILE = 128
_KB_GRAIN = 16
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def resolve_kb_tile(kb_tile: int, block_size: int) -> int:
    """The reference's rule: 0 = auto ``min(block_size, 128)``, and never
    more than the block."""
    return min(kb_tile or min(block_size, 128), block_size)


def check_contract(tile_block, q_sorted, q_pos, k_blocks, v_blocks,
                   q_tile: int, kb_tile: int, num_q_heads: int,
                   group: int) -> None:
    """Raise a shaped error for inputs the CUDA kernel does not take."""
    bh, ln, d = q_sorted.shape
    bkv, nb, bs, _ = k_blocks.shape
    problems = []
    if q_sorted.dtype not in runtime.DTYPE_CODES or \
            k_blocks.dtype != q_sorted.dtype or \
            v_blocks.dtype != q_sorted.dtype:
        problems.append(f"q_sorted and K/V of one dtype, bf16 or fp32 (got "
                        f"{q_sorted.dtype}/{k_blocks.dtype}/"
                        f"{v_blocks.dtype})")
    if d not in _HEAD_DIMS:
        problems.append(f"head_dim in {_HEAD_DIMS} (got {d})")
    if not 1 <= q_tile <= _MAX_Q_TILE or ln != tile_block.shape[1] * q_tile:
        problems.append(f"a q tile of 1..{_MAX_Q_TILE} rows with L = tiles "
                        f"x q_tile (got q_tile {q_tile}, L {ln}, "
                        f"{tile_block.shape[1]} tiles)")
    if kb_tile % _KB_GRAIN or kb_tile > 128 or bs % kb_tile:
        problems.append(f"kb_tile a multiple of {_KB_GRAIN} up to 128 "
                        f"dividing block_size (got {kb_tile}, block {bs})")
    if num_q_heads % group or bh != bkv * group:
        problems.append(f"BH = BKV·G with G | H (got BH={bh}, BKV={bkv}, "
                        f"G={group}, H={num_q_heads})")
    if not 1 <= bh <= 65535:
        problems.append(f"1..65535 query rows (got {bh})")
    if tile_block.dtype != torch.int32 or q_pos.dtype != torch.int32:
        problems.append("int32 tile_block and q_pos")
    if any(t.data_ptr() % 16 for t in (q_sorted, k_blocks, v_blocks)):
        problems.append("16-byte aligned q_sorted and K/V")
    if problems:
        raise ValueError(f"moba_fwd CUDA kernel needs {'; '.join(problems)}"
                         f" — q_sorted {tuple(q_sorted.shape)}, k_blocks "
                         f"{tuple(k_blocks.shape)}")


def moba_fwd(tile_block: torch.Tensor, q_sorted: torch.Tensor,
             q_pos: torch.Tensor, k_blocks: torch.Tensor,
             v_blocks: torch.Tensor, *, scale: float, block_size: int,
             n_tokens: int, num_q_heads: int, group: int,
             causal: bool = True, q_tile: int = 128, kb_tile: int = 0,
             grid: str = "grouped"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tile_block (BH, T) int32; q_sorted (BH, L, d); q_pos (BH, L) int32
    (-1 = pad); k_blocks/v_blocks (BKV, nb, bs, d).  Returns the partials
    (o (BH, L, d), m (BH, L), l (BH, L)), all fp32."""
    if grid not in GRIDS:
        raise ValueError(f"unknown moba_fwd grid {grid!r}: expected "
                         f"'grouped' or 'flat'")
    if q_sorted.device.type == "cpu":
        return tuple(ref.moba_partials_ref(
            tile_block, q_sorted, q_pos, k_blocks, v_blocks, scale=scale,
            block_size=block_size, n_tokens=n_tokens,
            num_q_heads=num_q_heads, group=group, causal=causal))
    if q_sorted.device.type != "cuda":
        raise ValueError(f"moba_fwd: tensors on {q_sorted.device}; expected "
                         f"cpu (plain version) or cuda (kernel)")
    kb_tile = resolve_kb_tile(kb_tile, block_size)
    tile_block, q_sorted, q_pos, k_blocks, v_blocks = (
        t.contiguous() for t in (tile_block, q_sorted, q_pos, k_blocks,
                                 v_blocks))
    check_contract(tile_block, q_sorted, q_pos, k_blocks, v_blocks, q_tile,
                   kb_tile, num_q_heads, group)
    return launch(tile_block, q_sorted, q_pos, k_blocks, v_blocks,
                  scale=scale, n_tokens=n_tokens, num_q_heads=num_q_heads,
                  group=group, causal=causal, q_tile=q_tile, kb_tile=kb_tile)


def launch(tile_block, q_sorted, q_pos, k_blocks, v_blocks, *, scale,
           n_tokens, num_q_heads, group, causal, q_tile, kb_tile):
    """One launch of the CUDA kernel on contiguous, checked inputs
    (``kb_tile`` already resolved)."""
    global LAUNCHES
    bh, ln, d = q_sorted.shape
    _, nb, bs, _ = k_blocks.shape
    dev = q_sorted.device
    o = torch.empty((bh, ln, d), dtype=torch.float32, device=dev)
    m = torch.empty((bh, ln), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    ptr = runtime.ptr
    lib = runtime.bind("moba_fwd", "moba_fwd", _ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.moba_fwd(
            ptr(tile_block), ptr(q_sorted), ptr(q_pos), ptr(k_blocks),
            ptr(v_blocks), ptr(o), ptr(m), ptr(l), bh, tile_block.shape[1],
            num_q_heads, group, nb, bs, d, n_tokens, q_tile, kb_tile,
            float(scale), int(causal), runtime.DTYPE_CODES[q_sorted.dtype],
            runtime.stream_of(q_sorted))
    runtime.check(err, f"moba_fwd (q_sorted {tuple(q_sorted.shape)}, "
                       f"k_blocks {tuple(k_blocks.shape)})")
    LAUNCHES += 1
    return o, m, l
