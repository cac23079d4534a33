"""Architecture registry: ``--arch <id>`` ids → config modules.

The port runs the paper's own models (moba-340m, moba-1b) and the
dense-family architectures; the other families of ``repro.configs``
(MoE, SSM, encoder-decoder, vision) join as their layer kinds are
ported (ROADMAP.md).
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
    "moba-340m": "moba_340m",
    "moba-1b": "moba_1b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, **kw) -> ModelConfig:
    return _module(arch).get_config(**kw)


def get_smoke_config(arch: str, **kw) -> ModelConfig:
    return _module(arch).get_smoke_config(**kw)
