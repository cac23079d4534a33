"""The MoE family in the port against the JAX package, on the same numpy
inputs and converted weights: ``models/moe.py::apply_moe`` (output, aux
loss and gradients, drop-free at T <= 64 and with dropped pairs past
it), the two MoE configs and their full-size parameter trees, the smoke
models' loss and gradients on ``flash``, greedy paged-engine tokens
under all three backends (two-row prefills past 64 tokens, so padding
and the other prompt share the capacity, a 66-slot decode batch, and
chunked prefill), and
checkpoints crossing the two packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import from_jax
from repro_torch.launch.train import train
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.serving.engine import Engine, EngineConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")


def _named(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a), dtype=dtype),
                        tree)


# ------------------------------------------------------------- apply_moe
def _drops(x, router, cfg, tokens):
    """(token, slot) pairs past their expert's capacity, by the
    reference's own routing of these inputs."""
    probs = jax.nn.softmax(jnp.asarray(x).reshape(tokens, -1) @ router)
    _, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    oh = np.asarray(jax.nn.one_hot(top_e, cfg.moe.num_experts,
                                   dtype=jnp.int32))
    oh = oh.reshape(tokens * cfg.moe.top_k, -1)
    pos = ((np.cumsum(oh, 0) - oh) * oh).sum(-1)
    return int((pos >= TMOE.capacity(tokens, cfg)).sum())


@pytest.mark.parametrize("b,s", [(2, 24), (3, 50)])   # T 48 and T 150
def test_apply_moe_equals_jax(b, s):
    cfg = JC.get_smoke_config("qwen2-moe-a2.7b")
    tcfg = TC.get_smoke_config("qwen2-moe-a2.7b")
    jp = JMOE.init_moe(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(b)
    # a shared offset skews the routing, so T > 64 overflows an expert
    x = (rng.normal(size=(b, s, cfg.d_model))
         + rng.normal(size=cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    drops = _drops(x, jp["router"], cfg, b * s)
    if b * s <= 64:
        assert drops == 0 and TMOE.capacity(b * s, tcfg) == b * s * 2
    else:
        assert drops >= 1

    def jloss(p, xx):
        out, aux = JMOE.apply_moe(p, xx, cfg)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = _torch(jp)
    leaves = [leaf.requires_grad_() for _, leaf in adamw.tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TMOE.apply_moe(tp, tx, tcfg)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(ct)).sum() + aux, leaves + [tx])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=2e-4)
    want = _named(jgp)
    want["x"] = np.asarray(jgx)
    got = dict(zip([n for n, _ in adamw.tree_leaves(tp)] + ["x"], grads))
    assert set(got) == set(want)
    for name, w in want.items():
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)


def test_apply_moe_bf16_equals_jax():
    cfg = JC.get_smoke_config("moonshot-v1-16b-a3b")
    jp = JMOE.init_moe(jax.random.PRNGKey(4), cfg)
    x = np.random.default_rng(9).normal(size=(2, 40, cfg.d_model))
    jout, jaux = jax.jit(lambda p, xx: JMOE.apply_moe(p, xx, cfg))(
        jp, jnp.asarray(x, jnp.bfloat16))
    out, aux = TMOE.apply_moe(_torch(jp), torch.tensor(
        x, dtype=torch.bfloat16), TC.get_smoke_config("moonshot-v1-16b-a3b"))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=3e-2)


def test_moe_dispatch_needs_no_host_sync():
    """A decode-sized call reads nothing back to the host: every shape is
    fixed by B·S, E and k, so under CUDA sync-debug mode it would not
    sync; here, its ops run with no ``.item()`` or ``nonzero``."""
    tcfg = TC.get_smoke_config("qwen2-moe-a2.7b")
    p = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg)
    for x in (torch.randn(8, 1, tcfg.d_model), torch.randn(2, 70, 64)):
        with torch.no_grad():
            out, aux = TMOE.apply_moe(p, x, tcfg)
        assert out.shape == x.shape and aux.shape == ()
    src = open(TMOE.__file__).read()
    assert ".item()" not in src and "nonzero" not in src


# ----------------------------------------------------- configs and params
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_and_full_size_shapes_equal_jax(arch):
    assert TC.ARCHS[arch] == JC.ARCHS[arch]
    for kw in (dict(), dict(key_conv_width=3), dict(moba=False)):
        jcfg, tcfg = JC.get_config(arch, **kw), TC.get_config(arch, **kw)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), kw
        want = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
            lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg)))
        assert TT.param_shapes(tcfg) == want, kw
    assert dataclasses.asdict(TC.get_smoke_config(arch)) == \
        dataclasses.asdict(JC.get_smoke_config(arch))
    gen = torch.Generator().manual_seed(0)
    got = jax.tree.map(lambda a: tuple(a.shape),
                       TT.init_lm(gen, TC.get_smoke_config(arch)))
    assert got == TT.param_shapes(TC.get_smoke_config(arch))


def test_qwen2_moe_parameter_count():
    """14,315,587,584 floats: 53.33 GiB in fp32 (the card's serving
    budget is reckoned from it)."""
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        TT.param_shapes(TC.get_config("qwen2-moe-a2.7b")),
        is_leaf=lambda t: isinstance(t, tuple)))
    assert n == 14_315_587_584


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    arch = request.param
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, tcfg, jparams, from_jax(_np(jparams), tcfg,
                                               device="cpu")


def test_smoke_loss_and_grads_equal_jax(smoke):
    """Batch 2 × 40: 80 tokens share the capacity, so pairs drop."""
    _, jcfg, tcfg, jparams, tparams = smoke
    tokens = np.random.default_rng(1).integers(0, 256, (2, 41)).astype(
        np.int32)
    (jloss, jparts), jgrads = jax.jit(
        jax.value_and_grad(JT.lm_loss, has_aux=True),
        static_argnums=(2, 3))(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, "flash")
    leaves = [leaf.detach().requires_grad_() for _, leaf in
              adamw.tree_leaves(tparams)]
    params = adamw.tree_like(tparams, leaves)
    loss, parts = TT.lm_loss(params, {"tokens": torch.from_numpy(tokens)},
                             tcfg, backend="flash", remat=True)
    grads = dict(adamw.tree_leaves(adamw.tree_like(
        params, torch.autograd.grad(loss, leaves))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=2e-4, rtol=2e-4)
    aux = float(parts["aux"].detach())
    assert aux > 0
    np.testing.assert_allclose(aux, float(jparts["aux"]),
                               rtol=2e-4)
    want = _named(jgrads)
    assert set(grads) == set(want)
    for name, w in want.items():
        err = float(np.abs(grads[name].numpy() - w).max())
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)


# ---------------------------------------------------------------- engine
def _serve(eng, prompts, gen):
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    return [list(r.out) for r in reqs]


def _dropping(monkeypatch) -> list:
    """Count the (token, slot) pairs each call over more than 64 tokens
    drops past the expert capacity."""
    drops, slots = [], TMOE.expert_slots

    def counted(top_e, num_experts, cap):
        onehot, pos, keep = slots(top_e, num_experts, cap)
        if top_e.shape[0] > 64:
            drops.append(int((~keep).sum()))
        return onehot, pos, keep

    monkeypatch.setattr(TMOE, "expert_slots", counted)
    return drops


@pytest.mark.parametrize("backend", ["reference", "xla", "flash"])
def test_engine_tokens_equal_jax(smoke, backend, monkeypatch):
    """Two prompts of 45 and 38 tokens prefilled together in one 64-token
    bucket: 128 tokens with padding share the capacity, and pairs
    drop."""
    _, jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (45, 38, 21)]
    ecfg = dict(max_seqs=3, max_seq_len=64, max_prefill_batch=2,
                attn_backend=backend)
    drops = _dropping(monkeypatch)
    got = _serve(Engine(tcfg, tparams, EngineConfig(**ecfg), device="cpu"),
                 prompts, 8)
    assert sum(drops) > 0
    want = _serve(JEngine(jcfg, jparams, JEngineConfig(**ecfg)), prompts, 8)
    assert got == want


def test_engine_tokens_equal_jax_past_64_slots(monkeypatch):
    """A decode batch of 66 slots is past the drop-free 64 tokens: every
    slot's token, the inactive ones' too, shares the capacity."""
    jcfg = JC.get_smoke_config("qwen2-moe-a2.7b")
    tcfg = TC.get_smoke_config("qwen2-moe-a2.7b")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(_np(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n, dtype=np.int32)
               for n in (30, 21, 17, 25)]
    ecfg = dict(max_seqs=66, max_seq_len=48, max_prefill_batch=1,
                attn_backend="xla")
    drops = _dropping(monkeypatch)
    got = _serve(Engine(tcfg, tparams, EngineConfig(**ecfg), device="cpu"),
                 prompts, 4)
    assert sum(drops) > 0
    want = _serve(JEngine(jcfg, jparams, JEngineConfig(**ecfg)), prompts, 4)
    assert got == want


def test_chunked_engine_tokens_equal_jax(smoke):
    _, jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (50, 29)]
    ecfg = dict(max_seqs=2, max_seq_len=64, max_prefill_batch=2,
                prefill_chunk=16, attn_backend="flash")
    got = _serve(Engine(tcfg, tparams, EngineConfig(**ecfg), device="cpu"),
                 prompts, 6)
    want = _serve(JEngine(jcfg, jparams, JEngineConfig(**ecfg)), prompts, 6)
    assert got == want


# ----------------------------------------------------------- checkpoints
def test_moe_checkpoints_cross_both_ways(smoke, tmp_path):
    arch, jcfg, tcfg, jparams, tparams = smoke
    JManager(str(tmp_path / "j"), async_writes=False).save(3, jparams)
    got, _, step = CheckpointManager(str(tmp_path / "j")).restore(
        jax.tree.map(torch.zeros_like, tparams))
    want = _named(jparams)
    assert step == 3 and {n for n, _ in adamw.tree_leaves(got)} == set(want)
    for name, leaf in adamw.tree_leaves(got):
        np.testing.assert_array_equal(leaf.numpy(), want[name],
                                      err_msg=name)
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(4, tparams, extra={"arch": arch})
    mgr.wait()
    back, extra, _ = JManager(str(tmp_path / "t"),
                              async_writes=False).restore(
        jax.tree.map(jnp.zeros_like, jparams))
    assert extra["arch"] == arch
    for name, leaf in _named(back).items():
        np.testing.assert_array_equal(leaf, want[name], err_msg=name)


def test_port_resumes_moe_training_from_jax_checkpoint(tmp_path):
    """The JAX trainer runs 3 qwen2-moe smoke steps, saving at steps 2
    and 3; the port's ``train()`` restores step 2 and its next loss is
    JAX's third."""
    import shutil

    from repro.launch.train import train as jtrain
    kw = dict(steps=4, batch=2, seq=40, smoke=True, attn_backend="xla",
              lr=1e-3, seed=7, save_interval=2)
    d = tmp_path / "jax"
    _, jlosses = jtrain("qwen2-moe-a2.7b", ckpt_dir=str(d), stop_at_step=3,
                        log_every=100, **kw)
    shutil.rmtree(d / "step_00000003")
    _, losses = train("qwen2-moe-a2.7b", ckpt_dir=str(d), resume="auto",
                      stop_at_step=3, device="cpu", **kw)
    assert len(losses) == 1
    np.testing.assert_allclose(losses[0], jlosses[2], atol=2e-4, rtol=2e-4)
