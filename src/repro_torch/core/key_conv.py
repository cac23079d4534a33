"""Short depthwise causal convolution on keys (paper Appendix B).

``k'_t = k_t + SiLU( sum_{l=0}^{W-1} W_l ⊙ k_{t-l} )``

Depthwise over every key channel (per kv head, per head dim), causal
(left-padded with zeros), SiLU activation, residual.  Applied to keys
*before* both routing (centroids) and attention, so the router's
gradients reach the conv weights.

Every function sums its taps in fp32 in one order,
``conv = 0 + s_0·w_0 + s_1·w_1 + …`` (``s_l`` the key ``l`` positions
back), then ``k + silu(conv)`` and a cast back to the key dtype.  So a
chunk convolved with :func:`apply_key_conv_with_state` from a zero state
is bit-equal to :func:`apply_key_conv`, chunked convolution is bit-equal
to one-shot, and a decode step's key is bit-equal to the one-shot key at
its position.  That needs each elementwise op to compute every element
with the same code: always so on the card; on the CPU, PyTorch's SiLU
runs a vectorized body and a scalar tail whose ``exp`` may differ in the
last bit, so there the equalities hold when a position's Hkv·d is a
multiple of 32 floats (every config's is) and the tensor is small
enough for one thread.  The tap sums are bit-equal at any shape.

Plain PyTorch ops: W shifted multiply-adds and a SiLU, as the reference
leaves them to XLA's fusion (no kernel).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def init_key_conv(gen: torch.Generator, width: int, num_kv_heads: int,
                  head_dim: int, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Weights shaped ``lead + (W, num_kv_heads, head_dim)``, N(0, 1) ·
    0.02 / W: small, so the residual branch starts near identity."""
    w = torch.randn(lead + (width, num_kv_heads, head_dim), generator=gen,
                    device=gen.device)
    return w * (0.02 / max(1, width))


def _conv(weights: torch.Tensor, hist: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 taps over ``hist`` (..., W-1+n, d), whose first W-1 rows are
    the left context of the n positions that follow."""
    width = weights.shape[0]
    depth = width - 1
    w = weights.float()
    conv = torch.zeros(hist.shape[:-2] + (n, hist.shape[-1]),
                       dtype=torch.float32, device=hist.device)
    for lag in range(width):
        conv = conv + hist[..., depth - lag:depth - lag + n, :] \
            * w[lag][..., None, :]
    return conv


def apply_key_conv(weights: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """weights (W, Hkv, d); k (..., Hkv, N, d) -> same shape as k."""
    kf = k.float()
    hist = F.pad(kf, (0, 0, weights.shape[0] - 1, 0))
    out = kf + F.silu(_conv(weights, hist, k.shape[-2]))
    return out.to(k.dtype)


def apply_key_conv_with_state(weights: torch.Tensor, k: torch.Tensor,
                              state: torch.Tensor) -> torch.Tensor:
    """Causal conv over a chunk with carried left context (chunked
    prefill).  k (B, Hkv, N, d) raw keys of the chunk; state (B, Hkv,
    W-1, d) the W-1 raw keys just before it (zeros for a fresh
    sequence).  Returns the convolved keys, shaped like k."""
    kf = k.float()
    hist = torch.cat([state.float(), kf], dim=-2)
    out = kf + F.silu(_conv(weights, hist, k.shape[-2]))
    return out.to(k.dtype)


def key_conv_state_init(width: int, batch: int, num_kv_heads: int,
                        head_dim: int, dtype=torch.bfloat16,
                        device="cuda") -> torch.Tensor:
    """Ring of the last W-1 raw keys, zeros."""
    return torch.zeros((batch, num_kv_heads, max(width - 1, 0), head_dim),
                       dtype=dtype, device=device)


def key_conv_state_update(state: torch.Tensor, k_raw: torch.Tensor,
                          q_len: torch.Tensor) -> torch.Tensor:
    """Advance a ring past a ragged prefill chunk.  state (B, Hkv, W-1,
    d); k_raw (B, Hkv, L, d) right-padded raw keys with valid length
    ``q_len`` (B,).  Returns the raw keys at the W-1 positions just
    before each row's new end; a row with q_len 0 keeps its state."""
    depth = state.shape[-2]
    if depth == 0:
        return state
    hist = torch.cat([state, k_raw.to(state.dtype)], dim=-2)
    idx = (q_len.long()[:, None]
           + torch.arange(depth, device=state.device))       # (B, W-1)
    idx = idx[:, None, :, None].expand(-1, hist.shape[1], -1,
                                       hist.shape[-1])
    return torch.gather(hist, -2, idx)


def apply_key_conv_decode(weights: torch.Tensor, k_new: torch.Tensor,
                          state: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  k_new (B, Hkv, 1, d); state (B, Hkv, W-1, d)
    the previous raw keys, most recent last.  Returns (convolved key,
    the state advanced by k_new)."""
    hist = torch.cat([state, k_new.to(state.dtype)], dim=-2)  # (B,Hkv,W,d)
    hf = hist.float()
    out = hf[..., -1:, :] + F.silu(_conv(weights, hf, 1))
    return out.to(k_new.dtype), hist[..., 1:, :]
