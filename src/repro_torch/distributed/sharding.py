"""Logical sharding rules on a device-free layout: parameter path →
spec, the batch of a layout's axes each dim is split over, and the
per-device shapes and bytes those specs give.

Axis conventions (the reference's ``distributed/sharding.py``):
  * ``("pod", "data")`` — the combined data-parallel / FSDP axes
    (gradients, batch, ZeRO-3)
  * ``"model"``         — tensor parallelism: heads / ffn / vocab /
    experts

A :class:`Layout` is the counterpart of the reference's ``Mesh``: the
shape and the axis names, and nothing else, so a 512-device layout is
costed with no device.  A spec is a tuple with one entry per dim: None
(replicated), an axis name, or a tuple of axis names.  The port's
models stay unsharded; these specs feed the dry run
(``launch/dryrun.py``), which costs one device's share of a cell.
"""
from __future__ import annotations

import dataclasses
import math
import re
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import MeshConfig, ShardingConfig

_ACTIVE: dict = {"layout": None, "cfg": None}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Devices laid out as ``shape`` over the named ``axes``."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"layout shape {self.shape} does not match "
                             f"its axes {self.axes}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.shape)

    def axis_size(self, axes) -> int:
        """Devices along ``axes``: None, one name or a tuple of names."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = dict(zip(self.axes, self.shape))
        return math.prod(sizes[a] for a in axes)


def as_spec(*entries) -> tuple:
    """A spec from its entries, in the reference's ``PartitionSpec``
    canonical form: a tuple of one axis becomes that axis, an empty one
    None."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                 else None if a == () else a for a in entries)


def make_layout(cfg: MeshConfig) -> Layout:
    return Layout(tuple(cfg.shape), tuple(cfg.axes))


@contextmanager
def use_mesh(layout: Layout, cfg: ShardingConfig):
    """Make ``layout`` and ``cfg`` the active ones for :func:`tp_enabled`
    and :func:`resolve` inside the block."""
    prev = dict(_ACTIVE)
    _ACTIVE.update(layout=layout, cfg=cfg)
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def data_axes(layout: Layout) -> Tuple[str, ...]:
    return tuple(a for a in layout.axes if a in ("pod", "data"))


def tp_enabled() -> bool:
    layout, cfg = _ACTIVE["layout"], _ACTIVE["cfg"]
    return (layout is not None and "model" in layout.axes
            and (cfg is None or cfg.tensor_parallel))


def resolve(spec: Sequence[Optional[str]]) -> Optional[tuple]:
    """The reference ``constrain``'s mapping of an activation spec on the
    active layout: ``'dp'`` → the data axes, ``'tp'`` → ``'model'`` when
    tensor parallelism is on, ``'sp'`` → ``'model'`` when sequence or
    tensor parallelism is on; other entries pass through.  None without
    an active layout (``constrain`` is then a no-op)."""
    layout = _ACTIVE["layout"]
    if layout is None:
        return None
    cfg = _ACTIVE["cfg"]
    use_tp = tp_enabled()
    use_sp = "model" in layout.axes and (cfg is None or cfg.sequence_parallel
                                         or cfg.tensor_parallel)
    out = []
    for s in spec:
        if s == "dp":
            out.append(data_axes(layout))
        elif s == "tp":
            out.append("model" if use_tp else None)
        elif s == "sp":
            out.append("model" if use_sp else None)
        else:
            out.append(s)
    return as_spec(*out)


# --------------------------------------------------------------- param rules
# path-regex → logical spec, first match wins. 'fsdp' resolves to the data
# axes when ZeRO-3 is on, 'tp' to the model axis.
_PARAM_RULES = [
    # embeddings (V, d): vocab over tp, d over fsdp
    (r"embed", ("tp", "fsdp")),
    # lm head (d, V): vocab over tp, d over fsdp
    (r"lm_head", ("fsdp", "tp")),
    # attention projections
    (r"wq$|wk$|wv$|w_qkv", ("fsdp", "tp")),     # (d_model, heads*dh)
    (r"wo$", ("tp", "fsdp")),                   # (heads*dh, d_model)
    # mlp
    (r"w_gate$|w_up$", ("fsdp", "tp")),
    (r"w_down$", ("tp", "fsdp")),
    # moe expert weights (E, d, f): experts over tp (EP), d over fsdp
    (r"experts.*w_(gate|up)$", (None, "fsdp", "tp")),
    (r"experts.*w_down$", (None, "tp", "fsdp")),
    (r"router$", ("fsdp", None)),
    # mamba2
    (r"in_proj$", ("fsdp", "tp")),
    (r"out_proj$", ("tp", "fsdp")),
    # norms / small vectors replicated
    (r"norm|scale|bias|a_log$|dt_bias$|d_skip$|conv|key_conv", None),
]


def spec_for_param(path: str, shape, layout: Layout,
                   cfg: ShardingConfig) -> tuple:
    """Resolve a parameter path to a spec on ``layout``.

    Dims not divisible by the mapped axis size fall back to replication
    (e.g. vocab 50280 on a 16-way model axis), as the reference's jit
    input shardings require."""
    ndim = len(shape)
    logical = None
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            logical = spec
            break
    if logical is None:
        return ()
    dax = data_axes(layout) if cfg.fsdp else None
    tp = ("model" if cfg.tensor_parallel and "model" in layout.axes
          else None)
    out = [dax if s == "fsdp" else tp if s == "tp" else s for s in logical]
    out = ([None] * (ndim - len(out)) + out if ndim >= len(out)
           else out[-ndim:])
    return as_spec(*(a if shape[i] % layout.axis_size(a) == 0 else None
                  for i, a in enumerate(out)))


def _shape_of(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_specs(params: dict, layout: Layout, cfg: ShardingConfig) -> dict:
    """A tree of ``params``' structure (tensors or shape tuples, as
    ``transformer.param_shapes`` gives) holding each leaf's spec; paths
    are the ``"/"``-joined keys."""
    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else spec_for_param(prefix + k, _shape_of(v), layout, cfg)
                for k, v in tree.items()}
    return walk(params, "")


def _full(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_shape(shape, spec, layout: Layout) -> tuple:
    """One device's block of a ``shape`` array under ``spec`` (a dim not
    divisible by its axes takes the ceiling, as XLA pads)."""
    return tuple(-(-n // layout.axis_size(a))
                 for n, a in zip(shape, _full(spec, len(shape))))


def local_bytes(shape, spec, layout: Layout, itemsize: int) -> int:
    """Bytes of one device's block of a ``shape`` array of ``itemsize``
    bytes an element under ``spec``."""
    return math.prod(local_shape(shape, spec, layout)) * itemsize


def without_axes(entries, axes) -> tuple:
    """A spec's ``entries`` with ``axes`` taken out of every one: the
    layout of the array once gathered over them."""
    out = []
    for a in entries:
        names = () if a is None else (a,) if isinstance(a, str) else a
        out.append(tuple(n for n in names if n not in axes))
    return as_spec(*out)
