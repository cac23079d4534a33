"""The Mamba-2 (``ssm``) and zamba2 (``shared_attn``) kinds in the port
against the JAX package, on the same numpy inputs and converted weights:
``models/mamba2.py`` in its three branches (one-shot, prefill into a
cache with T not a multiple of the chunk, the recurrent decode step),
``ssd_chunked``'s gradients, the configs and full-size parameter trees,
the smoke models' loss and gradients on ``flash``, ``serve_fixed``
tokens, ``serve()``'s fallback to the fixed loop and the engine's
refusal, training and checkpoints.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.launch import serve as JS
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import from_jax
from repro_torch.launch import serve as TS
from repro_torch.launch.train import train
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import UnsupportedFeatureError
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("mamba2-780m", "zamba2-1.2b")


def _named(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


# ------------------------------------------------------------ apply_mamba2
@pytest.fixture(scope="module")
def block():
    cfg = JC.get_smoke_config("mamba2-780m")
    p = JM.init_mamba2(jax.random.PRNGKey(2), cfg)
    # a nonzero dt_bias and conv taps of both signs, so every term counts
    p = dict(p, dt_bias=jnp.linspace(-1.0, 1.0, p["dt_bias"].shape[0]))
    return cfg, TC.get_smoke_config("mamba2-780m"), p, _torch(p)


@pytest.mark.parametrize("t", [40, 16])       # 40: padded to 48, chunk 16
def test_apply_mamba2_one_shot_equals_jax(block, t):
    jcfg, tcfg, jp, tp = block
    x = np.random.default_rng(t).normal(size=(2, t, 64)).astype(np.float32)
    jy, jc = JM.apply_mamba2(jp, jnp.asarray(x), jcfg)
    ty, tc = TM.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    assert jc is None and tc is None and ty.shape == (2, t, 64)
    _close(ty, jy, 2e-4, "y")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba2_prefill_then_decode_equals_jax(block, dtype):
    """Prefill 37 tokens (chunk 16: padded to 48) into a cache, then three
    recurrent decode steps; outputs and the cached conv tail and state
    after each call."""
    jcfg, tcfg, jp, tp = block
    tol = 2e-4 if dtype == "float32" else 3e-2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 64)).astype(np.float32)
    jcache = JM.init_mamba2_cache(jcfg, 2, jnp.dtype(dtype))
    tcache = TM.init_mamba2_cache(tcfg, 2, getattr(torch, dtype), "cpu")
    for lo, hi in ((0, 37), (37, 38), (38, 39), (39, 40)):
        jx = jnp.asarray(x[:, lo:hi], dtype)
        jy, jcache = JM.apply_mamba2(jp, jx, jcfg, jcache)
        ty, tcache = TM.apply_mamba2(
            tp, torch.tensor(x[:, lo:hi], dtype=getattr(torch, dtype)),
            tcfg, tcache)
        assert ty.dtype == getattr(torch, dtype)
        assert tcache["len"] == int(jcache["len"]) == hi
        _close(ty.float(), jy.astype(jnp.float32), tol, f"y {lo}:{hi}")
        _close(tcache["ssm"], jcache["ssm"], tol, f"ssm {lo}:{hi}")
        _close(tcache["conv"].float(), jcache["conv"].astype(jnp.float32),
               tol, f"conv {lo}:{hi}")


def test_ssd_chunked_grads_equal_jax():
    rng = np.random.default_rng(4)
    b, t, h, p, n, chunk = 2, 32, 3, 8, 5, 8
    args = [rng.normal(size=(b, t, h, p)),
            np.log1p(np.exp(rng.normal(size=(b, t, h)))),
            np.log(np.linspace(1.0, 16.0, h)), rng.normal(size=(b, t, n)),
            rng.normal(size=(b, t, n)), rng.normal(size=h)]
    args = [a.astype(np.float32) for a in args]
    ct = rng.normal(size=(b, t, h, p)).astype(np.float32)

    def jf(*a):
        return jnp.sum(JM.ssd_chunked(*a, chunk) * ct)

    jv, jg = jax.value_and_grad(jf, argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tv = (TM.ssd_chunked(*targs, chunk) * torch.from_numpy(ct)).sum()
    tg = torch.autograd.grad(tv, targs)
    _close(float(tv.detach()), float(jv), 2e-4, "value")
    for name, g, w in zip(("x", "dt", "a_log", "b", "c", "d_skip"), tg, jg):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert np.isfinite(g.numpy()).all(), name
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)


# ----------------------------------------------------- configs and params
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_configs_and_full_size_shapes_equal_jax(arch):
    assert TC.ARCHS[arch] == JC.ARCHS[arch]
    for kw in (dict(), dict(moba=False)):
        jcfg, tcfg = JC.get_config(arch, **kw), TC.get_config(arch, **kw)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), kw
        want = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
            lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg)))
        assert TT.param_shapes(tcfg) == want, kw
    assert dataclasses.asdict(TC.get_smoke_config(arch)) == \
        dataclasses.asdict(JC.get_smoke_config(arch))
    smoke = TC.get_smoke_config(arch)
    got = jax.tree.map(lambda a: tuple(a.shape), TT.init_lm(
        torch.Generator().manual_seed(0), smoke))
    assert got == TT.param_shapes(smoke)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    arch = request.param
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return (arch, jcfg, tcfg, jparams, np_params,
            from_jax(np_params, tcfg, device="cpu"))


def test_smoke_loss_and_grads_equal_jax(smoke):
    """Batch 2 × 40: chunk 16, so the last chunk is padded."""
    _, jcfg, tcfg, jparams, _, tparams = smoke
    tokens = np.random.default_rng(1).integers(0, 256, (2, 41)).astype(
        np.int32)
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(JT.lm_loss, has_aux=True),
        static_argnums=(2, 3))(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, "flash")
    leaves = [leaf.detach().requires_grad_() for _, leaf in
              adamw.tree_leaves(tparams)]
    params = adamw.tree_like(tparams, leaves)
    loss, _ = TT.lm_loss(params, {"tokens": torch.from_numpy(tokens)},
                         tcfg, backend="flash", remat=True)
    grads = dict(adamw.tree_leaves(adamw.tree_like(
        params, torch.autograd.grad(loss, leaves))))
    _close(float(loss.detach()), float(jloss), 2e-4, "loss")
    want = _named(jgrads)
    assert set(grads) == set(want)
    for name, w in want.items():
        err = float(np.abs(grads[name].numpy() - w).max())
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)


def test_shared_block_is_one_unstacked_dense_copy(smoke):
    arch, _, tcfg, _, _, tparams = smoke
    if arch != "zamba2-1.2b":
        assert "shared" not in tparams
        return
    assert set(tparams["blocks"]) == {"slot_0"}
    assert "key_conv" not in tparams["shared"]["attn"]
    assert tparams["shared"]["norm1"].shape == (tcfg.d_model,)
    caches = TT.init_caches(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    assert "centroids" not in caches["slot_1"]            # dense, not MoBA
    assert caches["slot_1"]["k"].shape[0] == 2            # one per group


# ---------------------------------------------------------- fixed serving
FIXED = dict(batch=3, prompt_len=37, gen=6, smoke=True)


@pytest.mark.parametrize("backend", ["reference", "flash"])
def test_serve_fixed_equals_jax(smoke, backend, monkeypatch):
    arch, _, _, _, np_params, _ = smoke
    want = np.asarray(JS.serve_fixed(arch, attn_backend=backend, **FIXED))
    monkeypatch.setattr(TT, "init_lm", lambda gen, cfg: from_jax(
        np_params, cfg, device=gen.device))
    got = TS.serve_fixed(arch, attn_backend=backend, device="cpu", **FIXED)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    # serve() falls back to the fixed loop, as JAX's does
    np.testing.assert_array_equal(
        TS.serve(arch, attn_backend=backend, device="cpu", **FIXED), want)


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_unsupported_reason_equals_jax(arch):
    for get in ("get_smoke_config", "get_config"):
        want = JE.unsupported_reason(getattr(JC, get)(arch))
        assert TE.unsupported_reason(getattr(TC, get)(arch)) == want
    assert TE.engine_supported(TC.get_config(arch)) == (arch not in ARCHS + (
        "seamless-m4t-medium", "llama-3.2-vision-90b"))


def test_engine_and_paged_caches_refuse_ssm(smoke):
    arch, _, tcfg, _, _, tparams = smoke
    with pytest.raises(UnsupportedFeatureError, match="paging granularity"):
        TE.Engine(tcfg, tparams, TE.EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        TT.init_paged_caches(tcfg, 8, 16, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_mode_exits_2(arch, capsys):
    with pytest.raises(SystemExit) as e:
        TS.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--requests", "1"])
    assert e.value.code == 2
    assert "paging granularity" in capsys.readouterr().err


# ------------------------------------------------ training and checkpoints
@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs(arch, tmp_path):
    params, losses = train(arch, steps=2, batch=2, seq=24, smoke=True,
                           attn_backend="flash", device="cpu",
                           ckpt_dir=str(tmp_path), save_interval=2)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]


def test_ssm_checkpoints_cross_both_ways(smoke, tmp_path):
    arch, _, _, jparams, _, tparams = smoke
    want = _named(jparams)
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
    for name, leaf in _named(back).items():
        np.testing.assert_array_equal(leaf, want[name], err_msg=name)
