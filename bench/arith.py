"""Frozen metric arithmetic: the H100's peaks, the model FLOPs of a step,
and the work MoBA attention needs at a cell's shapes.

Every count here is of the operation, not of an implementation: it
stays the same whatever kernels compute it.  ``cfg`` is a configuration
file of ``configs/`` as a dict.
"""
from __future__ import annotations

import math
from typing import Iterable

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least: the larger of FLOPs at the bf16
    peak and bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def _moba_layers(cfg: dict) -> int:
    pattern = cfg["layer_pattern"]
    return cfg["num_layers"] // len(pattern) * sum(
        1 for k in pattern if k == "moba")


def param_count(cfg: dict) -> int:
    """Parameters of a dense-family model: per layer the attention
    projections (and key-conv weights on MoBA layers, q/k norm scales),
    two RMSNorm scales and the SwiGLU MLP; the embedding, the final norm
    and an untied head."""
    if cfg["family"] != "dense":
        raise ValueError(f"param_count counts the dense family only, "
                         f"got {cfg['family']!r}")
    d, h, hkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    dh = cfg["head_dim"] or d // h
    attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
    if cfg["attention"].get("qk_norm"):
        attn += 2 * dh
    layer = attn + 2 * d + 3 * d * cfg["d_ff"]
    conv = cfg["moba"]["key_conv_width"] * hkv * dh
    n = cfg["num_layers"] * layer + _moba_layers(cfg) * conv
    n += cfg["vocab_size"] * d + d
    if not cfg["tie_embeddings"]:
        n += d * cfg["vocab_size"]
    return n


def matmul_params(cfg: dict) -> int:
    """N of 6·N·D: the parameters less an untied embedding table (a
    lookup, no matmul)."""
    n = param_count(cfg)
    if not cfg["tie_embeddings"]:
        n -= cfg["vocab_size"] * cfg["d_model"]
    return n


def train_flops(cfg: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step: 6·N·D."""
    return 6.0 * matmul_params(cfg) * rows * seq


def forward_flops(cfg: dict, tokens: int) -> float:
    """Model FLOPs of a forward over ``tokens`` tokens: 2·N·D."""
    return 2.0 * matmul_params(cfg) * tokens


def _keys_attended(seq: int, block: int, top_k: int):
    """(keys, blocks scored) summed over the queries of one causal
    sequence: query t selects min(top_k, own + 1) blocks, all but its own
    full, and attends its own block up to itself; routing scores the
    own + 1 blocks at or before its own."""
    keys = blocks = 0
    for t in range(seq):
        own = t // block
        nsel = min(top_k, own + 1)
        keys += (nsel - 1) * block + (t - own * block + 1)
        blocks += own + 1
    return keys, blocks


def moba_train_work(cfg: dict, rows: int, seq: int, el_bytes: int = 2):
    """MoBA attention's work in one training step, summed over its MoBA
    layers: ``{"fwd": (flops, bytes), "bwd": (flops, bytes)}`` and
    ``least_s``, the least time of the two phases of every layer.

    FLOPs: routing (2·d per query head and causal block) and QKᵀ and PV
    over the selected keys (4·d per query head and key) forward; the
    backward's four products and the recompute of QKᵀ, 2.5× the forward's
    attention.  Bytes: q, k, v read and o written forward; q, k, v, o, dO
    read and dq, dk, dv written backward, each once."""
    m = cfg["moba"]
    d, h, hkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    dh = cfg["head_dim"] or d // h
    keys, blocks = _keys_attended(seq, m["block_size"], m["top_k"])
    q_el, kv_el = rows * h * seq * dh, rows * hkv * seq * dh
    fwd_flops = rows * h * (4 * dh * keys + 2 * dh * blocks)
    bwd_flops = rows * h * 10 * dh * keys
    fwd_bytes = (2 * q_el + 2 * kv_el) * el_bytes
    bwd_bytes = (4 * q_el + 4 * kv_el) * el_bytes
    n = _moba_layers(cfg)
    return {"fwd": (n * fwd_flops, n * fwd_bytes),
            "bwd": (n * bwd_flops, n * bwd_bytes),
            "least_s": n * (least_time(fwd_flops, fwd_bytes)
                            + least_time(bwd_flops, bwd_bytes))}


def moba_decode_work(cfg: dict, kv_lens: Iterable[int], page: int,
                     el_bytes: int = 2, centroid_bytes: int = 4):
    """One paged MoBA decode call's work over the active rows whose
    post-append lengths are ``kv_lens``: ``(flops, bytes, least_s)``.

    A row of length L holds npg = ceil(L / page) pages; its query heads
    score every page's centroid (2·d each) and attend the keys of
    min(top_k, npg) pages, the own page up to L (4·d per key).  Bytes: q
    and o, the centroids of the row's pages, its block-table row, and
    K and V of the attended keys, each once.  Rows are computed
    together, so the call's least time is that of their summed work."""
    m = cfg["moba"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    dh = cfg["head_dim"] or cfg["d_model"] // h
    flops = nbytes = 0
    for n in kv_lens:
        if n <= 0:
            continue
        npg = math.ceil(n / page)
        keys = (min(m["top_k"], npg) - 1) * page + (n - (npg - 1) * page)
        flops += h * (2 * dh * npg + 4 * dh * keys)
        nbytes += (2 * h * dh * el_bytes + npg * hkv * dh * centroid_bytes
                   + npg * 4 + 2 * keys * hkv * dh * el_bytes)
    return flops, nbytes, least_time(flops, nbytes)
