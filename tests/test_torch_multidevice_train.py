"""Multi-device training in the PyTorch port against the JAX package,
every shard on the CPU.

* ``optim/compression.py``: ``compress``/``decompress`` bit-equal to
  the reference's in-process, on exact .5 quotients (round half to even)
  and an all-zero leaf (the 1e-12 floor); ``compressed_psum`` over 2, 4
  and 8 shards, two rounds with carried residuals, bit-equal to the
  reference's under ``shard_map``, every shard's mean equal, a bf16 leaf
  kept bf16, and the bytes it moves; a hypothesis property for the
  error-feedback identity.
* ``distributed/pipeline.py::pipeline_forward`` against the reference's
  (``tanh(x @ w)`` stages, ``tests/test_distributed.py``) at 4 stages
  and 4 microbatches; one microbatch and one stage against the stages
  applied in turn; its two errors.
* SP MoBA's backward: dq, dk, dv through ``moba_attention_sp`` on 2 and
  4 shards against ``jax.grad`` of the reference's ``moba_sparse_xla``
  in-process and of its ``moba_attention_sp`` on a (2, tp) mesh; the
  bytes its backward moves; the per-shard recompute keeping fewer bytes
  for the backward than the shards' plain calls.
* One ``make_train_step(backend="sp")`` step under a 4-shard group
  (remat, ``accum_in_loss``) against the reference's step jitted under
  its mesh.
* ``CheckpointManager.restore(devices=...)``: a JAX-written checkpoint
  placed by a devices tree, a tree of another structure refused, and a
  4-shard SP run resumed on 2 shards.

The reference's sharded functions run in ONE subprocess on 8 simulated
devices (JAX fixes its device count at start), started by an autouse
fixture so it runs while the in-process tests do.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.kernels import ref as JK
from repro.optim import compression as JC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoBAConfig, TrainConfig
from repro_torch.convert import from_jax
from repro_torch.distributed import moba_sp as SP
from repro_torch.distributed.pipeline import pipeline_forward
from repro_torch.kernels import ref as kref
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import compression as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)          # fp32 SP gradients
PSUM_SHARDS = (2, 4, 8)
PSUM_LEAVES = {"a": (6, 40), "b": (33,), "z": (5,)}   # b: bf16, z: zeros
SP_SHAPES = dict(q=(2, 4, 128, 16), k=(2, 2, 128, 16), v=(2, 2, 128, 16),
                 w=(2, 4, 128, 16))
SP_CFG = dict(block_size=16, top_k=3)
PIPE_CASES = ((4, 4), (4, 1), (1, 4))          # (stages, microbatches)
PIPE_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN = dict(global_batch_size=2, seq_len=64, total_steps=3, warmup_steps=1,
             microbatch=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _group(tp):
    return SP.CPGroup(["cpu"] * tp)


def _inputs() -> dict:
    """Every input of this file, from one seed: fed to both packages."""
    rng = np.random.default_rng(25)
    out = {}
    for n in PSUM_SHARDS:
        for r in range(2):
            for name, shape in PSUM_LEAVES.items():
                x = rng.normal(size=(n, *shape)).astype(np.float32)
                if name == "b":          # bf16-representable values
                    x = np.asarray(jnp.asarray(x, jnp.bfloat16),
                                   np.float32)
                out[f"{name}{n}_{r}"] = x * 0 if name == "z" else x
    for s_count in sorted({s for s, _ in PIPE_CASES}):
        out[f"ws{s_count}"] = (rng.normal(size=(s_count, 16, 16))
                               * 0.5).astype(np.float32)
    out["px"] = rng.normal(size=(8, 16)).astype(np.float32)
    for name, shape in SP_SHAPES.items():
        out[f"sp_{name}"] = rng.normal(size=shape).astype(np.float32)
    out["tokens"] = rng.integers(0, 256, (2, TRAIN["seq_len"] + 1)).astype(
        np.int32)
    params = T.init_lm(torch.Generator().manual_seed(0),
                       get_smoke_config("moba-340m"))
    for name, leaf in adamw.tree_leaves(params):
        out[f"param:{name}"] = leaf.numpy()
    return out


INPUTS = _inputs()


_JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_smoke_config
from repro.configs.base import MoBAConfig, ShardingConfig, TrainConfig
from repro.distributed import sharding as shmod
from repro.distributed.moba_sp import moba_attention_sp
from repro.distributed.pipeline import pipeline_forward
from repro.launch import steps as S
from repro.optim import adamw, compression

inp = dict(np.load(sys.argv[1]))
out = {}
scfg = ShardingConfig(fsdp=False, tensor_parallel=False,
                      sequence_parallel=False)
names = ("a", "b", "z")
for n in (2, 4, 8):
    mesh = shmod.make_compat_mesh((n,), ("data",))

    def body(*xs):
        tree, res = compression.compressed_psum(
            {k: x[0] for k, x in zip(names, xs[:3])}, ("data",),
            {k: x[0] for k, x in zip(names, xs[3:])})
        return (tuple(tree[k][None] for k in names)
                + tuple(res[k][None] for k in names))

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 6,
                          out_specs=(P("data"),) * 6, check_rep=False))
    res = [jnp.zeros(inp[f"{k}{n}_0"].shape, jnp.float32) for k in names]
    for r in range(2):
        gs = [jnp.asarray(inp[f"{k}{n}_{r}"],
                          jnp.bfloat16 if k == "b" else jnp.float32)
              for k in names]
        o = f(*gs, *res)
        res = list(o[3:])
        for k, x, rr in zip(names, o[:3], o[3:]):
            out[f"psum{n}_{r}_{k}"] = np.asarray(x.astype(jnp.float32))
            out[f"psum{n}_{r}_{k}_dtype"] = np.asarray(str(x.dtype))
            out[f"res{n}_{r}_{k}"] = np.asarray(rr)

out["pipe"] = np.asarray(pipeline_forward(
    lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp["ws4"]),
    jnp.asarray(inp["px"]), shmod.make_compat_mesh((4,), ("model",)),
    axis="model", num_microbatches=4))

cfg = MoBAConfig(block_size=16, top_k=3)
q, k, v, w = (jnp.asarray(inp[f"sp_{x}"]) for x in "qkvw")
for tp in (2, 4):
    mesh = shmod.make_compat_mesh((2, tp), ("data", "model"))
    with shmod.use_mesh(mesh, scfg):
        grads = jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(moba_attention_sp(q, k, v, cfg) * w),
            argnums=(0, 1, 2)))(q, k, v)
    for name, g in zip(("dq", "dk", "dv"), grads):
        out[f"sp{tp}_{name}"] = np.asarray(g)

mcfg = get_smoke_config("moba-340m")
params = {}                  # the port's initial params, by leaf path
for key, leaf in inp.items():
    if key.startswith("param:"):
        *parents, name = key[len("param:"):].split("/")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
tcfg = TrainConfig(global_batch_size=2, seq_len=64, total_steps=3,
                   warmup_steps=1, microbatch=2)
step = jax.jit(S.make_train_step(mcfg, tcfg, backend="sp", remat=True,
                                 accum_in_loss=True))
with shmod.use_mesh(shmod.make_compat_mesh((1, 4), ("data", "model")),
                    scfg):
    p1, st1, m = step(params, adamw.adamw_init(params),
                      {"tokens": jnp.asarray(inp["tokens"])})
out["train_loss"] = np.asarray(m["loss"])
for tag, tree in (("params", p1), ("mu", st1.mu)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"{tag}:{key}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """The reference's ``compressed_psum``, ``pipeline_forward``, SP
    gradients and SP train step on 8 simulated devices, in one
    subprocess started before this file's first test."""
    tmp = tmp_path_factory.mktemp("jax_multidevice")
    np.savez(tmp / "in.npz", **INPUTS)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_CODE),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, tmp / "out.npz"
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_run(jax_proc):
    proc, path = jax_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


# ---------------------------------------------------------- compression
def test_compress_bit_equal_to_jax():
    """Exact .5 quotients round half to even (scale 1: the max is 127),
    an all-zero leaf takes the 1e-12 floor, and a random leaf with a
    carried residual: q, scale and the new residual bit-equal."""
    rng = np.random.default_rng(3)
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.0],
                      np.float32)
    cases = [(halves, np.zeros_like(halves)),
             (np.zeros(7, np.float32), np.zeros(7, np.float32)),
             (rng.normal(size=(5, 11)).astype(np.float32),
              (rng.normal(size=(5, 11)) * 1e-3).astype(np.float32))]
    for g, r in cases:
        want = JC.compress(jnp.asarray(g), jnp.asarray(r))
        got = C.compress(_t(g), _t(r))
        assert got[0].dtype == torch.int8
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            C.decompress(got[0], got[1]).numpy(),
            np.asarray(JC.decompress(want[0], want[1])))
    q = C.compress(_t(halves), _t(np.zeros_like(halves)))[0]
    assert q[1:7].tolist() == [0, 2, 2, -0, -2, -2]


def test_init_residuals_are_fp32_zeros():
    params = {"w": torch.ones(3, 4, dtype=torch.bfloat16),
              "sub": {"b": torch.ones(5)}}
    res = C.init_residuals(params)
    for (pa, p), (pr, r) in zip(adamw.tree_leaves(params),
                                adamw.tree_leaves(res)):
        assert pa == pr and r.dtype == torch.float32
        assert r.shape == p.shape and not r.any()


def _psum_trees(n: int, r: int):
    return [{k: _t(INPUTS[f"{k}{n}_{r}"][s]).to(
        torch.bfloat16 if k == "b" else torch.float32) for k in PSUM_LEAVES}
        for s in range(n)]


def test_compressed_psum_bytes():
    """What crosses, by kind: the amax all-gather (fp32 scalars to every
    other shard), the int8 payloads to the lead, the means back."""
    n = 4
    g = _group(n)
    trees = _psum_trees(n, 0)
    C.compressed_psum(trees, [C.init_residuals(t) for t in trees], g)
    elems = {k: int(np.prod(s)) for k, s in PSUM_LEAVES.items()}
    assert dict(g.bytes) == {
        "amax": len(elems) * n * (n - 1) * 4,
        "payload": (n - 1) * sum(elems.values()),
        "result": (n - 1) * sum(e * (2 if k == "b" else 4)
                                for k, e in elems.items())}


def test_compressed_psum_needs_one_tree_a_shard():
    trees = _psum_trees(2, 0)
    with pytest.raises(ValueError, match="one tree"):
        C.compressed_psum(trees, [C.init_residuals(trees[0])], _group(2))


@hypothesis.settings(max_examples=8, deadline=None, derandomize=True,
                     suppress_health_check=list(hypothesis.HealthCheck))
@hypothesis.given(n=st.integers(2, 5), rounds=st.integers(1, 4),
                  size=st.integers(1, 50), spread=st.floats(1e-3, 1e3),
                  seed=st.integers(0, 2 ** 16))
def test_error_feedback_identity(n, rounds, size, spread, seed):
    """Σ over rounds of (compressed mean − true mean) = −mean of the
    final residuals (the error is carried, never lost), within fp32
    rounding: 1e-5 of the largest scale used, per element; and each
    round's mean within one scale of the true mean."""
    rng = np.random.default_rng(seed)
    g = _group(n)
    res = [{"x": torch.zeros(size)} for _ in range(n)]
    drift = torch.zeros(size, dtype=torch.float64)
    top = 0.0
    for _ in range(rounds):
        grads = [{"x": torch.from_numpy((rng.normal(size=size) * spread)
                                        .astype(np.float32))}
                 for _ in range(n)]
        gf = [t["x"] + r["x"] for t, r in zip(grads, res)]
        scale = max(float(x.abs().max()) for x in gf) / 127
        prev = max((float(r["x"].abs().max()) for r in res), default=0.0)
        top = max(top, scale)
        true = torch.stack([t["x"] for t in grads]).double().mean(0)
        means, res = C.compressed_psum(grads, res, g)
        err = means[0]["x"].double() - true
        assert float(err.abs().max()) <= (scale / 2 + prev) * (1 + 1e-5) \
            + 1e-6 * scale * 127
        drift += err
    final = torch.stack([r["x"] for r in res]).double().mean(0)
    assert float((drift + final).abs().max()) <= 1e-5 * top * 127


# ------------------------------------------------------------- pipeline
def _pipe(stages, mb):
    g = _group(stages)
    ws, x = _t(INPUTS[f"ws{stages}"]), _t(INPUTS["px"])
    out = pipeline_forward(lambda w, h: torch.tanh(h @ w), ws, x, g,
                           num_microbatches=mb)
    # each microbatch's activation crosses the S-1 stage boundaries, and
    # the last stage's output goes back to the lead
    per_mb = x[: 8 // mb].numel() * 4
    assert g.bytes.get("act", 0) == (stages - 1) * mb * per_mb
    assert g.bytes.get("out", 0) == (per_mb * mb if stages > 1 else 0)
    return out, ws, x


@pytest.mark.parametrize("stages,mb", PIPE_CASES[1:])
def test_pipeline_forward_edge_cases(stages, mb):
    """One microbatch (no overlap) and one stage (no send): the stages
    applied in turn to the whole batch, the reference's own check
    (``tests/test_distributed.py``)."""
    out, ws, want = _pipe(stages, mb)
    for s in range(stages):
        want = torch.tanh(want @ ws[s])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **PIPE_TOL)


def test_pipeline_forward_dict_params_in_order():
    """A nested dict of stacked leaves: stage s takes slice s of each."""
    g = _group(3)
    p = {"w": torch.randn(3, 4, 4), "sub": {"b": torch.randn(3, 4)}}
    x = torch.randn(6, 4)
    out = pipeline_forward(lambda q, h: h @ q["w"] + q["sub"]["b"], p, x, g,
                           num_microbatches=2)
    want = x
    for s in range(3):
        want = want @ p["w"][s] + p["sub"]["b"][s]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_pipeline_forward_errors():
    g = _group(4)
    ws, x = torch.zeros(4, 16, 16), torch.zeros(6, 16)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(lambda w, h: h @ w, ws, x, g, num_microbatches=4)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_forward(lambda w, h: h @ w, ws[:3], x[:4], g,
                         num_microbatches=4)


# -------------------------------------------------------- SP backward
def _sp_torch(tp):
    q, k, v = (_t(INPUTS[f"sp_{x}"]).requires_grad_() for x in "qkv")
    g = _group(tp)
    out = SP.moba_attention_sp(q, k, v, MoBAConfig(**SP_CFG), group=g)
    grads = torch.autograd.grad((out * _t(INPUTS["sp_w"])).sum(), (q, k, v))
    return g, grads


@pytest.fixture(scope="module")
def jax_sparse_grads():
    q, k, v, w = (jnp.asarray(INPUTS[f"sp_{x}"]) for x in "qkvw")
    cfg = JMoBAConfig(**SP_CFG)
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(JK.moba_sparse_xla(
        q, k, v, cfg) * w), argnums=(0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("tp", [2, 4])
def test_sp_grads_equal_jax_moba_sparse_xla(jax_sparse_grads, tp):
    want = jax_sparse_grads
    _, got = _sp_torch(tp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_sp_backward_bytes_equal_formula(tp):
    """Forward: q slices and K/V to tp-1 shards, outputs back; backward:
    dQ slices and every shard's dK, dV to the lead, dO slices out."""
    g, _ = _sp_torch(tp)
    b, h, nq, d = SP_SHAPES["q"]
    want = SP.sp_attention_bytes(b, h, SP_SHAPES["k"][1], nq, nq, d, tp, 4)
    assert dict(g.bytes) == want
    assert want["kv_grad"] == 2 * (tp - 1) * INPUTS["sp_k"].nbytes
    assert want["q_grad"] == (tp - 1) * INPUTS["sp_q"].nbytes // tp


def _saved_bytes(fn) -> int:
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("tp", [2, 4])
def test_per_shard_recompute_saves_fewer_bytes(tp):
    """What autograd keeps for the backward: the SP call (each shard under
    ``torch.utils.checkpoint``, holding its inputs) against the same
    shards' ``moba_sparse_xla`` calls without the recompute."""
    q, k, v = (_t(INPUTS[f"sp_{x}"]).requires_grad_() for x in "qkv")
    cfg = MoBAConfig(**SP_CFG)
    nq = q.shape[2]
    rows = nq // tp
    sp = _saved_bytes(lambda: SP.moba_attention_sp(q, k, v, cfg,
                                                   group=_group(tp)))
    plain = _saved_bytes(lambda: [kref.moba_sparse_xla(
        q[:, :, s * rows:(s + 1) * rows], k, v, cfg,
        q_positions=torch.arange(rows) + s * rows, tile=min(128, rows))
        for s in range(tp)])
    held = tp * (q[:, :, :rows].numel() + k.numel() + v.numel()) * 4
    assert sp + held < plain / 4, (sp, held, plain)


# ------------------------------------------------------ SP train step
@pytest.fixture(scope="module")
def smoke():
    """The smoke config and its seed-0 params as a nested dict of numpy
    arrays (the subprocess's JAX step starts from the same values)."""
    params = {}
    for key, leaf in INPUTS.items():
        if key.startswith("param:"):
            *parents, name = key[len("param:"):].split("/")
            node = params
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = leaf
    return get_smoke_config("moba-340m"), params


def _params(smoke):
    cfg, params = smoke
    return from_jax(params, cfg, device="cpu")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("accum_in_loss", [True, False])
def test_sp_train_step_equals_single_device(smoke, remat, accum_in_loss):
    """Under a 2-shard group the ``sp`` step equals the ``xla`` step (the
    same math on query slices), remat on or off, either accumulation."""
    cfg, _ = smoke
    tcfg = TrainConfig(**TRAIN)
    out = {}
    for backend in ("xla", "sp"):
        params = _params(smoke)
        step = S.make_train_step(cfg, tcfg, backend=backend, remat=remat,
                                 accum_in_loss=accum_in_loss)
        with SP.use_group(_group(2)):
            params, _, m = step(params, adamw.adamw_init(params),
                                {"tokens": _t(INPUTS["tokens"])})
        out[backend] = (float(m["loss"]), dict(adamw.tree_leaves(params)))
    assert abs(out["sp"][0] - out["xla"][0]) <= 2e-4
    for name, p in out["xla"][1].items():
        torch.testing.assert_close(out["sp"][1][name], p, rtol=2e-4,
                                   atol=2e-5)


# ------------------------------------------------------------- restore
def test_restore_jax_checkpoint_onto_devices_tree(smoke, tmp_path):
    """A checkpoint the reference's manager wrote restores into the port
    with a devices tree (a device or None a leaf); one of another
    structure raises."""
    cfg, jparams = smoke
    JManager(str(tmp_path), async_writes=False).save(
        3, jparams, extra={"data_step": 3})
    template = adamw.tree_like(
        _params(smoke), [torch.zeros_like(p) for _, p in
                         adamw.tree_leaves(_params(smoke))])
    names = [n for n, _ in adamw.tree_leaves(template)]
    devices = adamw.tree_like(template, [None if i % 2 else
                                         torch.device("cpu")
                                         for i in range(len(names))])
    mgr = CheckpointManager(str(tmp_path), async_writes=False)
    tree, extra, step = mgr.restore(template, devices=devices)
    assert step == 3 and extra == {"data_step": 3}
    want = dict(adamw.tree_leaves(_params(smoke)))
    for name, leaf in adamw.tree_leaves(tree):
        assert leaf.device == torch.device("cpu")
        torch.testing.assert_close(leaf, want[name], rtol=0, atol=0)
    wrong = dict(devices)
    wrong.pop(sorted(wrong)[0])
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(template, devices=wrong)


def test_sp_run_resumes_on_another_group(smoke, tmp_path):
    """Three steps under a 4-shard group; the same run saved after two
    and resumed under 2 shards (``restore(devices=...)``) gives the third
    step's loss within 2e-4 and params within 2e-4."""
    cfg, _ = smoke
    tcfg = dataclasses.replace(TrainConfig(**TRAIN), microbatch=1)
    step = S.make_train_step(cfg, tcfg, backend="sp")
    tokens = [_t(np.random.default_rng(i).integers(
        0, 256, (2, TRAIN["seq_len"] + 1))) for i in range(3)]

    def run(params, state, steps, group):
        losses = []
        with SP.use_group(group):
            for i in steps:
                params, state, m = step(params, state, {"tokens": tokens[i]})
                losses.append(float(m["loss"]))
        return params, state, losses

    params = _params(smoke)
    params, state, _ = run(params, adamw.adamw_init(params), range(2),
                           _group(4))
    mgr = CheckpointManager(str(tmp_path), async_writes=False)
    mgr.save(2, {"params": params, "mu": state.mu, "nu": state.nu})
    want_p, _, want = run(params, state, [2], _group(4))

    fresh = _params(smoke)
    template = {"params": fresh, "mu": adamw.adamw_init(fresh).mu,
                "nu": adamw.adamw_init(fresh).nu}
    devices = adamw.tree_like(template, [torch.device("cpu")] * len(
        adamw.tree_leaves(template)))
    tree, _, ck = mgr.restore(template, devices=devices)
    state = adamw.AdamWState(torch.tensor(ck, dtype=torch.int32),
                             tree["mu"], tree["nu"])
    got_p, _, got = run(tree["params"], state, [2], _group(2))
    assert abs(got[0] - want[0]) <= 2e-4
    want_p = dict(adamw.tree_leaves(want_p))
    for name, p in adamw.tree_leaves(got_p):
        torch.testing.assert_close(p, want_p[name], rtol=2e-4, atol=2e-4)


# ----------------------------------- against the reference's subprocess
# last in the file, so that the subprocess runs beside the tests above
@pytest.mark.parametrize("n", PSUM_SHARDS)
def test_compressed_psum_equals_jax_shard_map(jax_run, n):
    """Two rounds with carried residuals against the reference under
    ``shard_map``: every shard's mean bit-equal (its int32 psum and our
    int32 sum agree exactly, the fp32 arithmetic is the same in the same
    order), every shard's mean the same, the bf16 leaf kept bf16.  The
    new residuals agree within one ulp of ``gf = g + r``: XLA's CPU
    backend fuses ``gf - q·s`` into one multiply-add, torch rounds the
    product first.  So round 2 starts from the reference's residuals of
    round 1 (a residual one ulp off moves the shared scale by one ulp);
    ``test_error_feedback_identity`` carries the port's own."""
    g = _group(n)
    res = [C.init_residuals(t) for t in _psum_trees(n, 0)]
    for r in range(2):
        trees = _psum_trees(n, r)
        if r:
            res = [{k: _t(jax_run[f"res{n}_{r - 1}_{k}"][s])
                    for k in PSUM_LEAVES} for s in range(n)]
        gf = [{k: (t[k].float() + rs[k]).numpy() for k in PSUM_LEAVES}
              for t, rs in zip(trees, res)]
        means, res = C.compressed_psum(trees, res, g)
        for k in PSUM_LEAVES:
            assert str(jax_run[f"psum{n}_{r}_{k}_dtype"]) == (
                "bfloat16" if k == "b" else "float32")
            for s in range(n):
                assert means[s][k].dtype == (torch.bfloat16 if k == "b"
                                             else torch.float32)
                np.testing.assert_array_equal(
                    means[s][k].float().numpy(),
                    jax_run[f"psum{n}_{r}_{k}"][s])
                assert torch.equal(means[s][k], means[0][k])
                diff = np.abs(res[s][k].numpy()
                              - jax_run[f"res{n}_{r}_{k}"][s])
                assert (diff <= np.spacing(np.abs(gf[s][k]))).all()


def test_pipeline_forward_equals_jax(jax_run):
    """4 stages, 4 microbatches against the reference's schedule under
    ``shard_map``."""
    out, _, _ = _pipe(4, 4)
    np.testing.assert_allclose(out.numpy(), jax_run["pipe"], **PIPE_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_sp_grads_equal_jax_mesh(jax_run, tp):
    _, got = _sp_torch(tp)
    for name, a in zip(("dq", "dk", "dv"), got):
        np.testing.assert_allclose(a.numpy(), jax_run[f"sp{tp}_{name}"],
                                   **GRAD_TOL)


def test_sp_train_step_equals_jax_mesh(jax_run, smoke):
    """remat on, ``accum_in_loss`` over 2 microbatches, 4 shards: loss
    within 2e-4, the first moment (0.1 × the clipped gradient) within
    5e-3 of each leaf's max, params within 5e-3."""
    cfg, _ = smoke
    params = _params(smoke)
    step = S.make_train_step(cfg, TrainConfig(**TRAIN), backend="sp",
                             remat=True, accum_in_loss=True)
    g = _group(4)
    with SP.use_group(g):
        params, state, m = step(params, adamw.adamw_init(params),
                                {"tokens": _t(INPUTS["tokens"])})
    assert g.bytes["kv_grad"] > 0 and g.bytes["q_grad"] > 0
    np.testing.assert_allclose(float(m["loss"]), float(jax_run["train_loss"]),
                               rtol=2e-4, atol=2e-4)
    for tag, tree in (("params", params), ("mu", state.mu)):
        for name, leaf in adamw.tree_leaves(tree):
            want = jax_run[f"{tag}:{name}"]
            err = float(np.abs(leaf.detach().numpy() - want).max())
            bound = 5e-3 * (max(float(np.abs(want).max()), 1e-12)
                            if tag == "mu" else 1.0)
            assert err <= bound, (tag, name, err)
