"""FlashMoBA backward: the Hopper kernel's wrapper.

Replaces ``repro.kernels.moba_bwd.moba_bwd`` (the TPU's kb-tiled and flat
grids).  The CUDA kernel is ``csrc/moba_bwd.cu``; its header says what
bounds it on an H100 (bytes: q_sorted, dO and dQ live in device memory in
the sorted layout) and what the design does about that: one CTA per
segment of a key block's contiguous tile run, dK/dV in registers, dQ
written once per slot without atomics, a second pass summing each
block's segment partials in order.  bf16 runs on the tensor cores: the
block's K/V stay in shared memory, the segment's q/dO rows stream
through it once in 64-row slices (32 at d 128), and blocks above 128
keys split their keys across CTAs, each writing a dQ partial that this
wrapper sums in order (:func:`dq_partials`).  fp32 keeps a SIMT body
that walks the block 32 keys at a time (TF32 would break the fp32
tolerances).

The wrapper finds each block's tile run with a binary search on the
sorted ``tile_block`` (id ``nb`` = the inactive tail, whose dQ slots the
kernel zeroes) and cuts the runs into segments of at most ``RUN_TILES``
tiles (:func:`segments`), all on the card without a host sync.  Unlike
the TPU kernel, unvisited blocks come back as zeros, not garbage.

Device contract: a CPU tensor takes the plain PyTorch version
(``kernels/ref.py::moba_bwd_ref``); a CUDA tensor launches the kernel or
raises — there is no fallback.  The kernel takes q_sorted, dO and K/V
blocks of one dtype, bf16 or fp32, fp32 lse/delta, and (q/k, v) widths
(64, 64), (128, 128) or latent attention's (192, 128)
(``moba_fwd.WIDTHS``); in bf16 a block of any multiple of 16 keys (split across
``ceil(bs / SPLIT_KEYS)`` CTAs, one dQ partial each).  ``grid`` and
``kb_tile`` keep the reference's API and do not change the launch.

``LAUNCHES`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref, runtime
from repro_torch.kernels.moba_fwd import WIDTHS

LAUNCHES = 0

GRIDS = ("grouped", "flat")
_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# tiles per segment of a key block's run: pass 1 runs one CTA a segment
RUN_TILES = 8
# keys one CTA of the bf16 kernel holds; a longer block splits across CTAs
SPLIT_KEYS = 128
_BF16_BLOCK_GRAIN = 16


def dq_partials(block_size: int, dtype: torch.dtype) -> int:
    """The dQ partials the kernel writes: in bf16 one per ``SPLIT_KEYS``
    keys of the block (summed in order by the wrapper), in fp32 one."""
    if dtype == torch.bfloat16:
        return -(-block_size // SPLIT_KEYS)
    return 1


def segments(tile_block: torch.Tensor, nb: int,
             run_tiles: int = RUN_TILES) -> Tuple[torch.Tensor, ...]:
    """Cut every block's tile run into segments of at most ``run_tiles``
    tiles.  Returns int32 tables: ``seg_block``, ``seg_lo``, ``seg_hi``
    (BH, S) — each segment's block (-1 = a spare CTA) and tiles [lo, hi),
    with S = T // run_tiles + nb + 1 a static bound on the segments of a
    row; ``tail_lo`` (BH,) the first inactive tile; ``seg_first``,
    ``seg_count`` (BH, nb) each block's segments."""
    bh, n_tiles = tile_block.shape
    # first and one-past-last tile of every block id (nb = inactive tail)
    ids = torch.arange(nb + 1, dtype=torch.int32, device=tile_block.device)
    ids = ids.expand(bh, nb + 1).contiguous()
    start = torch.searchsorted(tile_block, ids).long()
    end = torch.searchsorted(tile_block, ids, right=True).long()
    count = (end - start)[:, :nb].add(run_tiles - 1).div(
        run_tiles, rounding_mode="floor")
    cum = torch.cumsum(count, dim=1)
    first = cum - count
    n_seg = n_tiles // run_tiles + nb + 1
    c = torch.arange(n_seg, device=tile_block.device).expand(bh, n_seg)
    j = torch.searchsorted(cum, c.contiguous(), right=True)   # nb = spare
    jc = j.clamp(max=nb - 1)
    lo = start.gather(1, jc) + (c - first.gather(1, jc)) * run_tiles
    hi = torch.minimum(lo + run_tiles, end.gather(1, jc))
    return tuple(t.to(torch.int32).contiguous() for t in (
        torch.where(j < nb, j, -1), lo, hi, start[:, nb], first, count))


def check_contract(q_sorted, do_sorted, lse_sorted, delta_sorted, k_blocks,
                   v_blocks, tile_block, q_pos, q_tile: int,
                   num_q_heads: int, group: int) -> None:
    """Raise a shaped error for inputs the CUDA kernel does not take."""
    bh, ln, d = q_sorted.shape
    bkv, _, bs, _ = k_blocks.shape
    widths = (d, k_blocks.shape[-1], v_blocks.shape[-1], do_sorted.shape[-1])
    problems = []
    if q_sorted.dtype not in runtime.DTYPE_CODES or any(
            t.dtype != q_sorted.dtype for t in (do_sorted, k_blocks,
                                                v_blocks)):
        problems.append(f"q_sorted, dO and K/V of one dtype, bf16 or fp32 "
                        f"(got {q_sorted.dtype}/{do_sorted.dtype}/"
                        f"{k_blocks.dtype}/{v_blocks.dtype})")
    if lse_sorted.dtype != torch.float32 or \
            delta_sorted.dtype != torch.float32:
        problems.append("fp32 lse and delta")
    if q_sorted.dtype == torch.bfloat16 and bs % _BF16_BLOCK_GRAIN:
        problems.append(f"in bf16 a block of a multiple of "
                        f"{_BF16_BLOCK_GRAIN} keys (got {bs})")
    if widths[0] != widths[1] or widths[2] != widths[3] or \
            widths[1:3] not in WIDTHS:
        problems.append(f"head_dim (q/k, v) in {WIDTHS} (got q/k/v/dO "
                        f"{widths})")
    if q_tile < 1 or ln != tile_block.shape[1] * q_tile:
        problems.append(f"L = tiles x q_tile (got q_tile {q_tile}, L {ln}, "
                        f"{tile_block.shape[1]} tiles)")
    if num_q_heads % group or bh != bkv * group:
        problems.append(f"BH = BKV·G with G | H (got BH={bh}, BKV={bkv}, "
                        f"G={group}, H={num_q_heads})")
    if not 1 <= bh <= 65535:
        problems.append(f"1..65535 query rows (got {bh})")
    if tile_block.dtype != torch.int32 or q_pos.dtype != torch.int32:
        problems.append("int32 tile_block and q_pos")
    if any(t.data_ptr() % 16 for t in (q_sorted, do_sorted, k_blocks,
                                       v_blocks)):
        problems.append("16-byte aligned q_sorted, dO and K/V")
    if problems:
        raise ValueError(f"moba_bwd CUDA kernel needs {'; '.join(problems)}"
                         f" — q_sorted {tuple(q_sorted.shape)}, k_blocks "
                         f"{tuple(k_blocks.shape)}")


def moba_bwd(tile_block: torch.Tensor, q_sorted: torch.Tensor,
             q_pos: torch.Tensor, do_sorted: torch.Tensor,
             lse_sorted: torch.Tensor, delta_sorted: torch.Tensor,
             k_blocks: torch.Tensor, v_blocks: torch.Tensor, *,
             scale: float, block_size: int, n_tokens: int,
             num_q_heads: int, group: int, causal: bool = True,
             q_tile: int = 128, kb_tile: int = 0, grid: str = "grouped"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward over the sorted layout (do_sorted and v_blocks dv wide).
    Returns (dq_sorted (BH, L, d), dk (BH, nb, bs, d), dv (BH, nb, bs,
    dv)), all fp32; dk/dv are per
    query head (the caller sums the GQA group) and zero on blocks no tile
    visits."""
    if grid not in GRIDS:
        raise ValueError(f"unknown moba_bwd grid {grid!r}: expected "
                         f"'grouped' or 'flat'")
    if q_sorted.device.type == "cpu":
        return tuple(ref.moba_bwd_ref(
            tile_block, q_sorted, q_pos, do_sorted, lse_sorted,
            delta_sorted, k_blocks, v_blocks, scale=scale,
            block_size=block_size, n_tokens=n_tokens,
            num_q_heads=num_q_heads, group=group, causal=causal))
    if q_sorted.device.type != "cuda":
        raise ValueError(f"moba_bwd: tensors on {q_sorted.device}; expected "
                         f"cpu (plain version) or cuda (kernel)")
    (tile_block, q_sorted, q_pos, do_sorted, lse_sorted, delta_sorted,
     k_blocks, v_blocks) = (t.contiguous() for t in (
         tile_block, q_sorted, q_pos, do_sorted, lse_sorted, delta_sorted,
         k_blocks, v_blocks))
    check_contract(q_sorted, do_sorted, lse_sorted, delta_sorted, k_blocks,
                   v_blocks, tile_block, q_pos, q_tile, num_q_heads, group)
    tables = segments(tile_block, k_blocks.shape[1])
    return launch(tables, q_sorted, q_pos, do_sorted, lse_sorted,
                  delta_sorted, k_blocks, v_blocks, scale=scale,
                  n_tokens=n_tokens, num_q_heads=num_q_heads, group=group,
                  causal=causal, q_tile=q_tile)


def launch(tables, q_sorted, q_pos, do_sorted, lse_sorted, delta_sorted,
           k_blocks, v_blocks, *, scale, n_tokens, num_q_heads, group,
           causal, q_tile):
    """One launch of the CUDA kernel (both passes) on contiguous, checked
    inputs and the segment ``tables`` of :func:`segments`."""
    global LAUNCHES
    bh, ln, d = q_sorted.shape
    _, nb, bs, dv_w = v_blocks.shape
    n_seg = tables[0].shape[1]
    dev = q_sorted.device
    splits = dq_partials(bs, q_sorted.dtype)
    dq = torch.empty((splits, bh, ln, d), dtype=torch.float32, device=dev)
    dk = torch.empty((bh, nb, bs, d), dtype=torch.float32, device=dev)
    dv = ref.empty_as(dk, dv_w)
    part_dk = torch.empty((bh, n_seg, bs, d), dtype=torch.float32,
                          device=dev)
    part_dv = ref.empty_as(part_dk, dv_w)
    ptr = runtime.ptr
    lib = runtime.bind("moba_bwd", "moba_bwd", _ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.moba_bwd(
            *map(ptr, tables), ptr(q_sorted), ptr(q_pos), ptr(do_sorted),
            ptr(lse_sorted), ptr(delta_sorted), ptr(k_blocks),
            ptr(v_blocks), ptr(dq), ptr(dk), ptr(dv), ptr(part_dk),
            ptr(part_dv), bh, ln // q_tile, n_seg, num_q_heads, group, nb,
            bs, d, dv_w, n_tokens, q_tile, float(scale), int(causal),
            runtime.DTYPE_CODES[q_sorted.dtype], runtime.stream_of(q_sorted))
    runtime.check(err, f"moba_bwd (q_sorted {tuple(q_sorted.shape)}, "
                       f"k_blocks {tuple(k_blocks.shape)})")
    LAUNCHES += 1
    # one reduction over the split dim (no atomics): the same sum on
    # every call
    return (dq[0] if splits == 1 else dq.sum(0)), dk, dv
