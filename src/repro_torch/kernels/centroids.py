"""Key-block centroids: the Hopper kernel's wrapper.

Replaces ``repro.kernels.centroids.block_centroids_kernel`` (the TPU's
``_centroid_kernel``).  The CUDA kernel is ``csrc/centroids.cu``; its
header says what bounds it on an H100 (bytes: every key read once) and
what the design does about that (16-byte loads, several in flight per
thread, fp32 sums combined once per CTA).

Device contract: a CPU tensor takes the plain PyTorch version
(``kernels/ref.py::centroids_ref``); a CUDA tensor launches the kernel or
raises — there is no fallback.  The kernel takes bf16 or fp32 keys with
head_dim 64 or 128, or latent attention's 192 (q/k 128 + 64).

``LAUNCHES`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref, runtime

LAUNCHES = 0

_HEAD_DIMS = (64, 128, 192)
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def check_contract(k: torch.Tensor, block_size: int) -> None:
    """Raise a shaped error for inputs the CUDA kernel does not take."""
    problems = []
    if k.dim() != 3:
        problems.append(f"keys of shape (rows, N, d) (got {k.dim()} dims)")
    else:
        if k.shape[-1] not in _HEAD_DIMS:
            problems.append(f"head_dim in {_HEAD_DIMS} (got {k.shape[-1]})")
        if not 1 <= k.shape[0] <= 65535 or k.shape[1] < 1:
            problems.append("1..65535 rows of at least one key")
    if k.dtype not in runtime.DTYPE_CODES:
        problems.append(f"dtype bf16 or fp32 (got {k.dtype})")
    if block_size < 1:
        problems.append(f"a positive block_size (got {block_size})")
    if k.data_ptr() % 16:
        problems.append("keys at a 16-byte aligned address")
    if problems:
        raise ValueError(f"block_centroids CUDA kernel needs "
                         f"{'; '.join(problems)} — k {tuple(k.shape)}")


def block_centroids_kernel(k: torch.Tensor, block_size: int) -> torch.Tensor:
    """k: (rows, N, d) -> (rows, nb, d) mean-pooled block centroids in
    k.dtype; the ragged tail block averages its valid rows only."""
    if k.device.type == "cpu":
        return ref.centroids_ref(k, block_size)
    if k.device.type != "cuda":
        raise ValueError(f"block_centroids: tensors on {k.device}; expected "
                         f"cpu (plain version) or cuda (kernel)")
    k = k.contiguous()
    check_contract(k, block_size)
    return launch(k, block_size)


def launch(k: torch.Tensor, block_size: int) -> torch.Tensor:
    """One launch of the CUDA kernel on contiguous, checked keys."""
    global LAUNCHES
    rows, n, d = k.shape
    nb = -(-n // block_size)
    out = torch.empty((rows, nb, d), dtype=k.dtype, device=k.device)
    lib = runtime.bind("centroids", "block_centroids", _ARGTYPES)
    with torch.cuda.device(k.device):
        err = lib.block_centroids(runtime.ptr(k), runtime.ptr(out), rows, n,
                                  block_size, d, runtime.DTYPE_CODES[k.dtype],
                                  runtime.stream_of(k))
    if err:
        runtime.check(err, f"block_centroids (k {tuple(k.shape)})")
    LAUNCHES += 1
    return out
