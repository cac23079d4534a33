"""Architecture registry: ``--arch <id>`` ids → config modules.

The port runs every architecture of ``repro.configs``: the paper's own
models (moba-340m, moba-1b) and the dense, MoE, SSM, hybrid,
encoder-decoder (seamless-m4t-medium) and vision (llama-3.2-vision-90b)
families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401  (public re-exports)
    ASSIGNED_SHAPES, AttentionConfig, Config, MeshConfig, MoBAConfig,
    ModelConfig, MoEConfig, ServeConfig, ShardingConfig, SSMConfig,
    TrainConfig, with_moba)

ARCHS = {
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-14b": "qwen3_14b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mamba2-780m": "mamba2_780m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "zamba2-1.2b": "zamba2_1_2b",
    "moba-340m": "moba_340m",
    "moba-1b": "moba_1b",
}

# the ten assigned architectures: every id but the paper's own models
ASSIGNED = [a for a in ARCHS if not a.startswith("moba-")]


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, **kw) -> ModelConfig:
    return _module(arch).get_config(**kw)


def get_smoke_config(arch: str, **kw) -> ModelConfig:
    return _module(arch).get_smoke_config(**kw)
