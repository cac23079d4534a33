"""Per-page K/V quantization for the paged serving cache.

The pool stores K/V pages in int8 or fp8 (e4m3, the OCP "fn" variant
with no inf: ``torch.float8_e4m3fn``) with one fp32 scale per (page, kv
head), while centroids and every routing input stay fp32: routing is
identical across ``kv_dtype`` modes and only the attended values carry
quantization error.

``scales_k`` / ``scales_v`` are ``(num_pages, hkv)`` fp32 pool leaves
beside ``pages_k`` / ``pages_v`` in
:data:`repro_torch.serving.paged_cache.PAGE_LEAVES`, so host swap moves
payload and scales together.  A page's scale is ``amax / qmax`` over its
*valid* tokens (1.0 for an all-zero or empty page, keeping dequant a
no-op), symmetric, zero-point-free:

    payload = clip(round(x / scale))     (int8; fp8 rounds in the cast)
    x̂       = payload · scale

Quantization happens on append (``paged_append_prefill`` /
``paged_append_decode`` requantize each touched page from an fp32
staging view); dequantization at the last moment — in registers
inside the CUDA decode kernel, or at the densify/gather step of the
plain paths.  ``torch.round`` rounds half to even like ``jnp.round``,
and both fp8 casts round to nearest even after the clip, so payloads
are byte-equal to the JAX package's on the same input.
"""
from __future__ import annotations

import torch

# ``fp32`` = unquantized: pages stored at the engine compute dtype.
KV_DTYPES = ("fp32", "int8", "fp8")

PAYLOAD_DTYPES = {
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}

# symmetric clip points: int8 keeps ±127 (no -128 asymmetry); e4m3's
# largest finite is 448 (the fn variant has no inf to overflow into)
QMAX = {
    "int8": 127.0,
    "fp8": 448.0,
}


def kv_dtype_of(dtype) -> str:
    """Pool payload dtype → ``kv_dtype`` name (``"fp32"`` for any
    unquantized storage dtype, bf16 included)."""
    for name, pd in PAYLOAD_DTYPES.items():
        if dtype == pd:
            return name
    return "fp32"


def payload_dtype(kv_dtype: str) -> torch.dtype:
    if kv_dtype not in PAYLOAD_DTYPES:
        raise ValueError(
            f"kv_dtype {kv_dtype!r} has no quantized payload; "
            f"quantized modes: {sorted(PAYLOAD_DTYPES)}")
    return PAYLOAD_DTYPES[kv_dtype]


def compute_scale(x: torch.Tensor, reduce_axes, kv_dtype: str,
                  where=None) -> torch.Tensor:
    """Per-group fp32 scale ``amax / qmax`` with amax taken over
    ``reduce_axes`` (optionally masked by ``where``); all-zero groups
    get scale 1.0 so dequantization stays a no-op.

    The division is taken as ``amax · fl32(1/qmax)``: that is what XLA
    compiles the reference's ``amax / qmax`` to under ``jit`` (a
    division by a constant becomes a product with its reciprocal), so
    the scales are bit-equal to the JAX engine's; a true division
    differs from it by one ulp in many scales."""
    mag = x.float().abs()
    if where is not None:
        mag = mag * where.float()
    amax = torch.amax(mag, dim=tuple(reduce_axes))
    # a Python scalar meets an fp32 tensor as fp32: fl32(1/qmax)
    return torch.where(amax > 0.0, amax * (1.0 / QMAX[kv_dtype]),
                       torch.ones_like(amax))


def quantize(x: torch.Tensor, scale: torch.Tensor,
             kv_dtype: str) -> torch.Tensor:
    """fp32 values → payload dtype.  ``scale`` must broadcast against
    ``x`` (callers expand the per-(page, head) scale themselves)."""
    qmax = QMAX[kv_dtype]
    y = x.float() / scale
    if kv_dtype == "int8":
        return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    return torch.clamp(y, -qmax, qmax).to(PAYLOAD_DTYPES[kv_dtype])


def dequantize(payload: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Payload → fp32."""
    return payload.float() * scale
