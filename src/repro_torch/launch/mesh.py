"""The production layouts: 16 × 16 devices over ``data``, ``model``,
or 2 × 16 × 16 over ``pod``, ``data``, ``model`` (the reference's
``launch/mesh.py``).  No device is touched: the dry run costs them."""
from __future__ import annotations

from repro_torch.configs.base import MeshConfig
from repro_torch.distributed.sharding import Layout, make_layout


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(shape=(2, 16, 16) if multi_pod else (16, 16),
                      axes=("pod", "data", "model") if multi_pod
                      else ("data", "model"))


def production_layout(*, multi_pod: bool = False) -> Layout:
    return make_layout(mesh_config(multi_pod=multi_pod))
