"""The port's sharding rules (``repro_torch.distributed.sharding``), the
production layouts (``launch/mesh.py``) and the batch and cache specs
(``launch/steps.py``) against the JAX package's, with no device.

* Every parameter leaf of the 10 assigned archs at full width, on the
  16 × 16 and 2 × 16 × 16 layouts, under the default ``ShardingConfig``,
  with ``tensor_parallel=False`` and with ``fsdp=False``: the port's spec
  equals ``tuple(repro.distributed.sharding.spec_for_param(...))`` called
  with a duck mesh (``shape`` and ``axis_names``) on the leaves of
  ``jax.eval_shape(init_lm)``.  One device's param and AdamW bytes
  (``launch/dryrun.py::state_bytes``) equal those summed from the JAX
  specs over the same leaves.
* ``batch_specs`` and ``cache_specs`` equal ``batch_shardings`` and
  ``cache_shardings`` (their ``NamedSharding`` replaced by the bare
  spec) for every assigned arch and shape on both layouts, ``long_500k``'s
  sequence over every axis included; one device's cache bytes equal
  those summed from the JAX specs.
* ``resolve`` equals ``constrain``'s mapping of ``dp``/``tp``/``sp``.
"""
import math
import types

import jax
import jax.numpy as jnp
import pytest

from repro import configs as JC
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.distributed import sharding as JSH
from repro.launch import mesh as JMESH
from repro.launch import steps as JSTEPS
from repro.models import transformer as JT
from repro.optim import adamw as JADAMW
from repro_torch import configs as TC
from repro_torch.configs.base import ShardingConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_config, production_layout
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = TC.ASSIGNED
SHAPES = sorted(TC.ASSIGNED_SHAPES)
SCFGS = {"default": {}, "no_tp": {"tensor_parallel": False},
         "no_fsdp": {"fsdp": False}}
LAYOUTS = (False, True)                   # multi_pod


def _duck(multi_pod: bool):
    """A stand-in for the reference's production mesh: the ``shape`` and
    ``axis_names`` its rules read, no device."""
    mc = JMESH.mesh_config(multi_pod=multi_pod)
    return types.SimpleNamespace(shape=dict(zip(mc.axes, mc.shape)),
                                 axis_names=tuple(mc.axes))


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_local(shape, spec, mesh) -> int:
    """Elements of one device's block under a JAX spec (every mapped dim
    divides: the rules fall back to replication otherwise)."""
    n = 1
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        axes = (() if axes is None else (axes,) if isinstance(axes, str)
                else axes)
        size = math.prod(mesh.shape[a] for a in axes)
        assert dim % size == 0
        n *= dim // size
    return n


@pytest.fixture(scope="module")
def jax_params():
    """{arch: [(path, shape)]} of ``jax.eval_shape(init_lm)`` at full
    width, and {arch: [(path, shape)]} of AdamW's ``mu``."""
    params, mus = {}, {}
    for arch in ARCHS:
        cfg = JC.get_config(arch)
        ps = jax.eval_shape(lambda k: JT.init_lm(k, cfg),
                            jax.random.PRNGKey(0))
        st = jax.eval_shape(JADAMW.adamw_init, ps)
        params[arch] = [(_path(p), tuple(x.shape)) for p, x in
                        jax.tree_util.tree_flatten_with_path(ps)[0]]
        mus[arch] = [(_path(p), tuple(x.shape), x.dtype) for p, x in
                     jax.tree_util.tree_flatten_with_path(st.mu)[0]]
    return params, mus


def test_assigned_and_layouts():
    assert TC.ASSIGNED == JC.ASSIGNED and len(ARCHS) == 10
    for mp in LAYOUTS:
        mc, jmc = mesh_config(multi_pod=mp), JMESH.mesh_config(multi_pod=mp)
        assert (mc.shape, mc.axes) == (jmc.shape, jmc.axes)
        layout = production_layout(multi_pod=mp)
        assert layout.shape == jmc.shape and layout.axes == jmc.axes
        assert layout.size == (512 if mp else 256)
        assert SH.data_axes(layout) == JSH.data_axes(_duck(mp))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, jax_params):
    """Every leaf's spec, on both layouts under the three configs."""
    cfg = TC.get_config(arch)
    port_leaves = tree_leaves(TT.param_shapes(cfg))
    ref = jax_params[0][arch]
    assert [p for p, _ in port_leaves] == [p for p, _ in ref]
    assert [tuple(s) for _, s in port_leaves] == [s for _, s in ref]
    for mp in LAYOUTS:
        mesh, layout = _duck(mp), production_layout(multi_pod=mp)
        for kw in SCFGS.values():
            specs = dict(tree_leaves(SH.param_specs(
                TT.param_shapes(cfg), layout, ShardingConfig(**kw))))
            for path, shape in ref:
                want = tuple(JSH.spec_for_param(path, shape, mesh,
                                                JShardingConfig(**kw)))
                assert specs[path] == want, (path, mp, kw)


def test_vocab_fallback_replicates():
    """mamba2-780m's vocab of 50,280 does not divide 16: its embedding
    stays replicated over ``model``."""
    cfg = TC.get_config("mamba2-780m")
    layout = production_layout()
    spec = SH.spec_for_param("embed", (cfg.vocab_size, cfg.d_model),
                             layout, ShardingConfig())
    assert cfg.vocab_size == 50280 and spec == (None, "data")
    assert SH.local_shape((cfg.vocab_size, cfg.d_model), spec,
                          layout) == (50280, cfg.d_model // 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_equal_jax(arch, jax_params):
    """One device's fp32 params and AdamW mu/nu bytes (train), from the
    port's specs, against the sum over the JAX leaves under the JAX
    specs."""
    cfg = TC.get_config(arch)
    for mp in LAYOUTS:
        mesh, layout = _duck(mp), production_layout(multi_pod=mp)
        for kw in SCFGS.values():
            jcfg = JShardingConfig(**kw)
            want_p = 4 * sum(_jax_local(s, JSH.spec_for_param(
                p, s, mesh, jcfg), mesh) for p, s in jax_params[0][arch])
            want_mu = sum(_jax_local(s, JSH.spec_for_param(
                p, s, mesh, jcfg), mesh) * jnp.dtype(dt).itemsize
                for p, s, dt in jax_params[1][arch])
            got = DR.state_bytes(cfg, "train_4k", layout,
                                 ShardingConfig(**kw))
            assert got["params"] == want_p == got["grads"]
            assert got["adam_mu"] == want_mu == got["adam_nu"]


@pytest.fixture
def bare_shardings(monkeypatch):
    """``batch_shardings``/``cache_shardings`` give their bare specs."""
    monkeypatch.setattr(JSTEPS, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, bare_shardings):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    for mp in LAYOUTS:
        mesh, layout = _duck(mp), production_layout(multi_pod=mp)
        for shape in SHAPES:
            info = TC.ASSIGNED_SHAPES[shape]
            b, s = info["global_batch"], info["seq_len"]
            want = {k: tuple(v) for k, v in
                    JSTEPS.batch_shardings(jcfg, mesh, b).items()}
            assert S.batch_specs(cfg, layout, b) == want
            if info["kind"] != "decode":
                continue
            jc = jax.eval_shape(lambda: JT.init_caches(jcfg, b, s))
            jspecs = JSTEPS.cache_shardings(
                jc, jcfg, mesh, b, long_context=(shape == "long_500k"))
            jflat = {_path(p): (tuple(x.shape), x.dtype) for p, x in
                     jax.tree_util.tree_flatten_with_path(jc)[0]}
            want = {_path(p): tuple(v) for p, v in
                    jax.tree_util.tree_flatten_with_path(
                        jspecs, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))[0]}
            tc = TT.init_caches(cfg, b, s, device="meta")
            got = dict(tree_leaves(S.cache_specs(
                tc, cfg, layout, b, long_context=True)))
            assert got == want, (shape, mp)
            seq_axes = {got[p][3] for p in got if p.endswith("/k")}
            assert seq_axes <= {SH.data_axes(layout) + ("model",)
                                if shape == "long_500k" else "model"}
            # the port keeps ``len`` on the host; JAX an int32 a group
            want_bytes = sum(
                _jax_local(sh, want[p], mesh) * jnp.dtype(dt).itemsize
                for p, (sh, dt) in jflat.items() if not p.endswith("len"))
            assert DR.state_bytes(cfg, shape, layout, ShardingConfig())[
                "caches"] == want_bytes


@pytest.mark.parametrize("mp", LAYOUTS)
@pytest.mark.parametrize("scfg", sorted(SCFGS) + ["sp"])
def test_resolve_equals_constrain(mp, scfg, monkeypatch):
    """``resolve`` against the spec the reference's ``constrain`` hands
    ``with_sharding_constraint`` on the same layout and config."""
    kw = {"sp": {"tensor_parallel": False, "sequence_parallel": True}
          }.get(scfg, SCFGS.get(scfg))
    seen = []
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(JSH.jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    monkeypatch.setitem(JSH._ACTIVE, "mesh", _duck(mp))
    monkeypatch.setitem(JSH._ACTIVE, "cfg", JShardingConfig(**kw))
    specs = [("dp", "sp", None), ("dp", None, "tp"), ("tp", None, None),
             ("dp", "tp", None, None), (None, "tp"), ("dp", None, None)]
    for spec in specs:
        JSH.constrain(None, spec)
    layout = production_layout(multi_pod=mp)
    assert SH.resolve(specs[0]) is None and not SH.tp_enabled()
    with SH.use_mesh(layout, ShardingConfig(**kw)):
        assert [SH.resolve(s) for s in specs] == seen
        monkeypatch.setitem(JSH._ACTIVE, "mesh", _duck(mp))
        assert SH.tp_enabled() == JSH.tp_enabled()
    assert SH.resolve(specs[0]) is None


def test_local_shape_and_bytes():
    layout = SH.Layout((2, 4), ("data", "model"))
    assert SH.local_shape((8, 6, 5), (("data", "model"), None), layout) \
        == (1, 6, 5)
    assert SH.local_shape((7,), ("model",), layout) == (2,)
    assert SH.as_spec(("data",), (), ("pod", "data")) == (
        "data", None, ("pod", "data"))
    assert SH.local_bytes((8, 12), ("data", "model"), layout, 2) == 24
    assert SH.without_axes((("data", "model"), "data", None),
                           ("data",)) == ("model", None, None)
    with pytest.raises(ValueError):
        SH.Layout((2, 4), ("data",))
