"""Cases shared by ``test_torch_encdec.py`` (seamless-m4t-medium) and
``test_torch_vlm.py`` (llama-3.2-vision-90b): the port's ``cross`` and
``decoder`` kinds against the JAX package on the same numpy inputs and
converted weights.  Each test file defines the ``arch`` fixture and
imports these tests, so pytest collects them once per family.

The stub frontends' inputs go where each family takes them: image
embeddings as ``cross_kv`` (vlm), frame embeddings as ``src_embeds``
through the encoder (encdec).  Tolerances: fp32 2e-4, gradients within
5e-3 of each leaf's largest entry, greedy tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import serve as JS
from repro.launch import steps as JSTEPS
from repro.launch import train as JTRAIN
from repro.models import transformer as JT
from repro.optim import adamw as JADAM
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import from_jax
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as S
from repro_torch.launch import train as TTRAIN
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import UnsupportedFeatureError

BACKENDS = ("reference", "xla", "flash")
# 53 tokens: 4 key blocks of 16 with top_k 2, so the decoder's MoBA routes
FIXED = dict(batch=3, prompt_len=53, gen=6, smoke=True)


def named(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        g = np.asarray(got[name].detach())
        err = float(np.abs(g - w).max())
        assert np.isfinite(g).all(), name
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)


def extras(cfg, seed: int, batch: int) -> dict:
    """numpy stub-frontend inputs of ``cfg``'s family, as
    ``launch/steps.py::stub_frontend_inputs`` draws them."""
    return {k: v.numpy() for k, v in S.stub_frontend_inputs(
        cfg, np.random.default_rng(seed), batch, "cpu").items()}


@pytest.fixture(scope="module")
def smoke(arch):
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return (jcfg, tcfg, jparams, np_params,
            from_jax(np_params, tcfg, device="cpu"))


# ----------------------------------------------------- configs and params
def test_smoke_param_trees_equal_jax(arch):
    for moba in (True, False):
        jcfg = JC.get_smoke_config(arch, moba=moba)
        tcfg = TC.get_smoke_config(arch, moba=moba)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        want = jax.tree.map(lambda a: tuple(a.shape),
                            JT.init_lm(jax.random.PRNGKey(0), jcfg))
        assert TT.param_shapes(tcfg) == want
        got = jax.tree.map(lambda a: tuple(a.shape), TT.init_lm(
            torch.Generator().manual_seed(0), tcfg))
        assert got == want


# ------------------------------------------------------- model vs the JAX
@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_apply_with_cross_kv_equals_jax(smoke, backend):
    """Logits of 2 × 40 tokens (3 key blocks of 16) attending onto a
    random (2, M, d) memory."""
    jcfg, tcfg, jparams, _, tparams = smoke
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 40)).astype(np.int32)
    mem = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    want, _, _ = JT.lm_apply(jparams, jnp.asarray(tokens), jcfg,
                             backend=backend, cross_kv=jnp.asarray(mem))
    got, aux, _ = TT.lm_apply(tparams, torch.from_numpy(tokens), tcfg,
                              backend=backend,
                              cross_kv=torch.from_numpy(mem))
    assert got.shape == (2, 40, 256) and float(aux) == 0.0
    close(got, want, 2e-4, f"logits {backend}")


def test_loss_and_grads_equal_jax(smoke):
    """``lm_loss`` on ``flash`` with the family's stub inputs in the
    batch; every leaf's gradient (the encoder's, the cross attention's)."""
    jcfg, tcfg, jparams, _, tparams = smoke
    tokens = np.random.default_rng(1).integers(0, 256, (2, 41)).astype(
        np.int32)
    batch = {"tokens": tokens, **extras(tcfg, 2, 2)}
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(JT.lm_loss, has_aux=True),
        static_argnums=(2, 3))(jax.tree.map(jnp.asarray, jparams),
                               jax.tree.map(jnp.asarray, batch), jcfg,
                               "flash")
    leaves = [leaf.detach().requires_grad_() for _, leaf in
              adamw.tree_leaves(tparams)]
    params = adamw.tree_like(tparams, leaves)
    loss, _ = TT.lm_loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                         tcfg, backend="flash", remat=True)
    close(float(loss.detach()), float(jloss), 2e-4, "loss")
    grads_close(dict(adamw.tree_leaves(adamw.tree_like(
        params, torch.autograd.grad(loss, leaves)))), named(jgrads))


def test_accumulated_step_matches_jax(smoke):
    """One step of batch 4 in 2 microbatches on ``xla``: the stub inputs
    split with the tokens (rows [0, 2) and [2, 4)), as the reference's
    reshape splits every leaf.  Loss within 2e-4 and, through the first
    moment, every gradient leaf within 5e-3 of its max."""
    jcfg, tcfg, jparams, _, tparams = smoke
    jt = JTrainConfig(global_batch_size=4, seq_len=32, total_steps=3,
                      warmup_steps=1, microbatch=2)
    tokens = np.random.default_rng(6).integers(0, 256, (4, 33)).astype(
        np.int32)
    batch = {"tokens": tokens, **extras(tcfg, 7, 4)}
    jstep = jax.jit(JSTEPS.make_train_step(jcfg, jt, backend="xla"))
    _, jstate, jm = jstep(jparams, JADAM.adamw_init(jparams),
                          jax.tree.map(jnp.asarray, batch))
    params = adamw.tree_like(tparams, [v.detach().clone() for _, v in
                                       adamw.tree_leaves(tparams)])
    step = S.make_train_step(tcfg, TrainConfig(**dataclasses.asdict(jt)),
                             backend="xla")
    _, state, m = step(params, adamw.adamw_init(params),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    close(float(m["loss"]), float(jm["loss"]), 2e-4, "loss")
    grads_close(dict(adamw.tree_leaves(state.mu)), named(jstate.mu))


# ---------------------------------------------------------- fixed serving
@pytest.fixture(scope="module")
def jax_fixed(arch):
    """JAX's fixed loop on ``reference``, the tokens every backend of the
    port must give."""
    return np.asarray(JS.serve_fixed(arch, attn_backend="reference",
                                     **FIXED))


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_fixed_equals_jax(arch, smoke, jax_fixed, backend,
                                monkeypatch):
    """``serve_fixed`` draws the stub inputs from its seeded generator
    after the prompts, as JAX's does, so both see the same inputs."""
    np_params = smoke[3]
    monkeypatch.setattr(TT, "init_lm", lambda gen, cfg: from_jax(
        np_params, cfg, device=gen.device))
    got = TS.serve_fixed(arch, attn_backend=backend, device="cpu", **FIXED)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, jax_fixed)
    if backend == "flash":   # serve() falls back to the fixed loop
        np.testing.assert_array_equal(
            TS.serve(arch, attn_backend=backend, device="cpu", **FIXED),
            jax_fixed)


def test_dense_caches_layout(smoke):
    """A ``decoder`` slot's self-attention cache sits under ``"self"``; a
    ``cross`` slot has none.  A prefill and a decode step advance every
    ``len``."""
    _, tcfg, _, _, tparams = smoke
    caches = TT.init_caches(tcfg, 2, 40, dtype=torch.float32, device="cpu")
    for i, kind in enumerate(tcfg.layer_pattern):
        name = f"slot_{i}"
        assert (name in caches) == (kind != "cross"), kind
        if kind == "decoder":
            assert set(caches[name]) == {"self"}
            assert "centroids" in caches[name]["self"]
    mem = {k: torch.from_numpy(v) for k, v in extras(tcfg, 4, 2).items()}
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 33)).astype(np.int32))
    prefill = S.make_prefill_step(tcfg, backend="flash")
    decode = S.make_decode_step(tcfg, backend="flash")
    _, caches = prefill(tparams, tokens, caches, **mem)
    assert TT._cache_len(caches) == 33
    tok, caches = decode(tparams, tokens[:, :1], caches, **mem)
    assert TT._cache_len(caches) == 34 and tok.shape == (2, 1)
    assert all(TT._self_cache(c)["len"] == 34 for c in caches.values())


def test_engine_and_paged_caches_refuse(arch, smoke):
    _, tcfg, _, _, tparams = smoke
    assert not TE.engine_supported(TC.get_config(arch))
    with pytest.raises(UnsupportedFeatureError, match="paging granularity"):
        TE.Engine(tcfg, tparams, TE.EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        TT.init_paged_caches(tcfg, 8, 16, device="cpu")


@pytest.mark.parametrize("mode", ["stream", "openloop"])
def test_engine_modes_exit_2(arch, mode, capsys):
    with pytest.raises(SystemExit) as e:
        TS.main(["--arch", arch, "--smoke", "--device", "cpu", "--mode",
                 mode, "--requests", "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and len(err.strip().splitlines()) == 1


def test_batch_mode_serves_through_the_fixed_loop(arch, capsys):
    TS.main(["--arch", arch, "--smoke", "--device", "cpu", "--mode",
             "batch", "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert "decode: 2×3 tokens" in capsys.readouterr().out


# ------------------------------------------------ training and checkpoints
def test_train_losses_equal_jax(arch, smoke, monkeypatch):
    """``train()`` in both packages from the same weights: the stub
    inputs are one ``default_rng(0)`` draw handed to every step."""
    np_params = smoke[3]
    kw = dict(steps=2, batch=2, seq=24, smoke=True, attn_backend="xla")
    _, want = JTRAIN.train(arch, **kw)
    monkeypatch.setattr(TT, "init_lm", lambda gen, cfg: from_jax(
        np_params, cfg, device=gen.device))
    _, got = TTRAIN.train(arch, device="cpu", **kw)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_checkpoints_cross_both_ways(smoke, tmp_path):
    _, _, jparams, _, tparams = smoke
    want = named(jparams)
    JManager(str(tmp_path / "j"), async_writes=False).save(3, jparams)
    got, _, _ = CheckpointManager(str(tmp_path / "j")).restore(
        jax.tree.map(torch.zeros_like, tparams))
    assert {n for n, _ in adamw.tree_leaves(got)} == set(want)
    for name, leaf in adamw.tree_leaves(got):
        np.testing.assert_array_equal(leaf.numpy(), want[name],
                                      err_msg=name)
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(4, tparams)
    mgr.wait()
    back, _, _ = JManager(str(tmp_path / "t"), async_writes=False).restore(
        jax.tree.map(jnp.zeros_like, jparams))
    for name, leaf in named(back).items():
        np.testing.assert_array_equal(leaf, want[name], err_msg=name)
