"""Paged-pool storage dtypes.

The port serves unquantized pools only: pages at the engine compute
dtype, no scale leaves.  The int8/fp8 payloads with per-(page, kv head)
scales of ``repro.core.quantization`` come with the quantized-pages
slice (ROADMAP.md); their names are kept here so configuration errors
read the same in both packages.
"""
from __future__ import annotations

import torch

# ``fp32`` = unquantized: pages stored at the engine compute dtype.
KV_DTYPES = ("fp32", "int8", "fp8")

PAYLOAD_DTYPES = {
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}


def kv_dtype_of(dtype) -> str:
    """Pool payload dtype → ``kv_dtype`` name (``"fp32"`` for any
    unquantized storage dtype, bf16 included)."""
    for name, pd in PAYLOAD_DTYPES.items():
        if dtype == pd:
            return name
    return "fp32"
