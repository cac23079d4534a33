"""Parameter bridge from the JAX package's weights to the port's.

``from_jax`` takes the nested dict of numpy arrays that
``jax.tree.map(np.asarray, repro.models.transformer.init_lm(key, cfg))``
gives (stacked ``blocks/slot_i`` leaves with a leading layer-group axis)
and returns the port's parameters: the same tree of fp32 tensors, each
leaf checked against :func:`repro_torch.models.transformer.param_shapes`.
This module imports no JAX; callers hand it plain arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
             device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)

    def walk(tree, spec, path):
        if isinstance(spec, dict):
            if not isinstance(tree, dict) or set(tree) != set(spec):
                got = sorted(tree) if isinstance(tree, dict) else type(tree)
                raise ValueError(f"{path or '<root>'}: expected keys "
                                 f"{sorted(spec)}, got {got}")
            return {k: walk(tree[k], spec[k], f"{path}/{k}")
                    for k in spec}
        arr = np.asarray(tree, dtype=np.float32)
        if arr.shape != tuple(spec):
            raise ValueError(f"{path}: expected shape {tuple(spec)}, got "
                             f"{arr.shape}")
        return torch.from_numpy(arr.copy()).to(dev)

    return walk(params_np, T.param_shapes(cfg), "")
