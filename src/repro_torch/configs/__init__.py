"""Architecture registry: ``--arch <id>`` ids → config modules.

The port serves the paper's own model; the other architectures of
``repro.configs`` join as their layer kinds are ported (ROADMAP.md).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401  (public re-exports)
    ASSIGNED_SHAPES, AttentionConfig, Config, MeshConfig, MoBAConfig,
    ModelConfig, MoEConfig, ServeConfig, ShardingConfig, SSMConfig,
    TrainConfig, with_moba)

ARCHS = {
    "moba-340m": "moba_340m",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, **kw) -> ModelConfig:
    return _module(arch).get_config(**kw)


def get_smoke_config(arch: str, **kw) -> ModelConfig:
    return _module(arch).get_smoke_config(**kw)
