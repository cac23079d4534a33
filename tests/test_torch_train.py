"""The port's training path against the JAX package: loss and gradients
of the smoke moba-340m under every backend, remat, AdamW and its
schedule, the synthetic data, whole train steps, and the CLI.

Both packages get the same converted weights and numpy-made batches; the
JAX ``flash`` path runs its Pallas kernels in interpret mode.  Loss at
fp32 2e-4, every gradient leaf within 5e-3 of its largest entry, train
losses within 1e-4.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JADAM
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as S
from repro_torch.launch.train import train
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.serving.scheduler import UnsupportedFeatureError

ROOT = pathlib.Path(__file__).resolve().parent.parent
BACKENDS = ("reference", "xla", "flash")


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("moba-340m")
    tcfg = get_smoke_config("moba-340m")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(seed, b=2, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s + 1)).astype(
        np.int32)


def _leaves(tree):
    return dict(adamw.tree_leaves(tree))


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach().numpy()
        err = float(np.abs(g - w).max())
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)


# ------------------------------------------------------------ loss + grads
@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_loss_and_grads_match_jax(smoke, backend):
    jcfg, tcfg, jparams, tparams = smoke
    tokens = _tokens(1)
    # ragged CE mask: the reference's optional 'mask' leaf
    mask = np.ones((2, 32), np.float32)
    mask[1, 20:] = 0
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(JT.lm_loss, has_aux=True),
        static_argnums=(2, 3))(jparams, {"tokens": jnp.asarray(tokens),
                                         "mask": jnp.asarray(mask)},
                               jcfg, backend)
    params = {k: v for k, v in tparams.items()}
    leaves = [leaf.detach().requires_grad_() for _, leaf in
              adamw.tree_leaves(params)]
    params = adamw.tree_like(params, leaves)
    loss, metrics = TT.lm_loss(params, {"tokens": torch.from_numpy(tokens),
                                        "mask": torch.from_numpy(mask)},
                               tcfg, backend=backend)
    grads = adamw.tree_like(params, torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=2e-4, rtol=2e-4)
    assert float(metrics["aux"]) == 0.0
    _assert_grads_close(_leaves(grads), _jax_leaves(jgrads))


def test_remat_equals_no_remat(smoke):
    _, tcfg, _, tparams = smoke
    tokens = torch.from_numpy(_tokens(2))
    out = []
    for remat in (False, True):
        leaves = [leaf.detach().clone().requires_grad_() for _, leaf in
                  adamw.tree_leaves(tparams)]
        params = adamw.tree_like(tparams, leaves)
        loss, _ = TT.lm_loss(params, {"tokens": tokens}, tcfg,
                             backend="flash", remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, atol=1e-6, rtol=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# -------------------------------------------------------------------- optim
def test_adamw_update_matches_jax(smoke):
    """One update from random grads and moments at step 3: decayed and
    undecayed leaves, clipping active."""
    jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(3)
    jp = jax.tree.map(np.asarray, jparams)

    def like(scale):
        return jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
            jp)

    grads, mu, nu = like(1.0), like(0.1), jax.tree.map(np.abs, like(0.01))
    jt = JTrainConfig(total_steps=20, warmup_steps=2)
    jparams2, jstate, jm = JADAM.adamw_update(
        jparams, jax.tree.map(jnp.asarray, grads),
        JADAM.AdamWState(jnp.asarray(3, jnp.int32),
                         jax.tree.map(jnp.asarray, mu),
                         jax.tree.map(jnp.asarray, nu)), jt)

    def conv(tree):
        return from_jax(tree, tcfg, device="cpu")

    params = conv(jp)
    state = adamw.AdamWState(torch.tensor(3, dtype=torch.int32), conv(mu),
                             conv(nu))
    params, state, m = adamw.adamw_update(
        params, conv(grads), state, TrainConfig(total_steps=20,
                                                warmup_steps=2))
    assert int(state.step) == int(jstate.step) == 4
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    for got, want in ((params, jparams2), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        g, w = _leaves(got), _jax_leaves(want)
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], atol=1e-6,
                                       rtol=1e-6, err_msg=name)


def test_cosine_schedule_matches_jax():
    jt = JTrainConfig(learning_rate=3e-4, total_steps=50, warmup_steps=5)
    tt = TrainConfig(learning_rate=3e-4, total_steps=50, warmup_steps=5)
    jlr, tlr = JADAM.cosine_schedule(jt), adamw.cosine_schedule(tt)
    for step in (0, 1, 4, 5, 6, 27, 49, 50, 80):
        np.testing.assert_allclose(float(tlr(step)),
                                   float(jlr(jnp.asarray(step))), rtol=1e-6)


def test_synthetic_lm_batches_bit_equal_to_jax():
    for kw in (dict(), dict(copy_period=16)):
        cfg = dict(vocab_size=256, seq_len=64, global_batch=4, seed=3, **kw)
        ours = SyntheticLM(DataConfig(**cfg), host_id=1, num_hosts=2)
        ref = JSyntheticLM(JDataConfig(**cfg), host_id=1, num_hosts=2)
        for step in (0, 7):
            np.testing.assert_array_equal(ours.batch_at(step)["tokens"],
                                          ref.batch_at(step)["tokens"])


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_three_train_steps_match_jax(smoke, backend):
    jcfg, tcfg, jparams, _ = smoke
    jt = JTrainConfig(global_batch_size=2, seq_len=32, total_steps=3,
                      warmup_steps=1)
    tt = TrainConfig(**dataclasses.asdict(jt))
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=32,
                                  global_batch=2, seed=0))
    jstep = jax.jit(JS.make_train_step(jcfg, jt, backend=backend))
    tstep = S.make_train_step(tcfg, tt, backend=backend)
    jp, js = jparams, JADAM.adamw_init(jparams)
    tp = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    ts = adamw.adamw_init(tp)
    for step in range(3):
        tokens = data.batch_at(step)["tokens"]
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(tokens)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=0)
    assert int(ts.step) == 3


# --------------------------------------------------------------------- CLI
def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_train_cli_smoke_on_cpu():
    res = _cli("--smoke", "--steps", "3", "--device", "cpu",
               "--attn-backend", "flash")
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("loss") == 2          # steps 0 and 2 are logged


def test_train_defaults_to_cuda():
    """Without ``--device cpu`` the entry points ask for the card and
    raise on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-card error is not "
                    "reachable here")
    with pytest.raises(RuntimeError, match="cuda"):
        train("moba-340m", steps=1, batch=1, seq=16)
    res = _cli("--smoke", "--steps", "1")
    assert res.returncode != 0 and "cuda" in res.stderr


OUT_OF_SCOPE = {
    "ckpt_dir": dict(ckpt_dir="/nonexistent/ckpt"),
    "resume": dict(resume="auto"),
    "microbatch": dict(microbatch=2),
}


@pytest.mark.parametrize("flag", OUT_OF_SCOPE)
def test_out_of_scope_train_flags_raise(flag):
    with pytest.raises(UnsupportedFeatureError):
        train("moba-340m", steps=1, batch=1, seq=16, device="cpu",
              **OUT_OF_SCOPE[flag])


def test_out_of_scope_cli_flag_exits_2():
    res = _cli("--smoke", "--device", "cpu", "--microbatch", "2")
    assert res.returncode == 2 and "microbatch" in res.stderr


@pytest.mark.parametrize("kw", [dict(microbatch=4), dict(accum=True)],
                         ids=["microbatch", "accum_in_loss"])
def test_make_train_step_rejects_accumulation(smoke, kw):
    _, tcfg, _, _ = smoke
    with pytest.raises(UnsupportedFeatureError):
        S.make_train_step(tcfg, TrainConfig(microbatch=kw.get("microbatch",
                                                              0)),
                          accum_in_loss=kw.get("accum", False))
