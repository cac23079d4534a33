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
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

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
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
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


# ------------------------------------------------- gradient accumulation
ACCUM = {"microbatch": dict(microbatch=2),
         "accum_in_loss": dict(microbatch=2, accum_in_loss=True)}


def _one_step(step_fn, params, tokens):
    params = {k: v for k, v in params.items()}
    params = adamw.tree_like(params, [v.detach().clone() for _, v in
                                      adamw.tree_leaves(params)])
    state = adamw.adamw_init(params)
    params, state, m = step_fn(params, state,
                               {"tokens": torch.from_numpy(tokens)})
    return params, state, m


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("mode", ACCUM)
def test_accumulated_step_matches_jax(smoke, mode, backend):
    """One step of batch 4 in 2 microbatches, per-microbatch backward or
    one loss over the chunks: loss within 2e-4 and, through the first
    moment (0.1 x the clipped gradient after one step from zero), every
    gradient leaf within 5e-3 of its max, against the reference's step."""
    jcfg, tcfg, jparams, tparams = smoke
    kw = dict(ACCUM[mode])
    accum = kw.pop("accum_in_loss", False)
    jt = JTrainConfig(global_batch_size=4, seq_len=32, total_steps=3,
                      warmup_steps=1, **kw)
    tt = TrainConfig(**dataclasses.asdict(jt))
    tokens = _tokens(6, b=4)
    jstep = jax.jit(JS.make_train_step(jcfg, jt, backend=backend,
                                       accum_in_loss=accum))
    _, jstate, jm = jstep(jparams, JADAM.adamw_init(jparams),
                          {"tokens": jnp.asarray(tokens)})
    _, state, m = _one_step(S.make_train_step(tcfg, tt, backend=backend,
                                              accum_in_loss=accum),
                            tparams, tokens)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-4)
    _assert_grads_close(_leaves(state.mu), _jax_leaves(jstate.mu))


@pytest.mark.parametrize("mode", ACCUM)
def test_accumulated_step_equals_one_shot_step(smoke, mode):
    """Equal-length chunks: the mean of the chunks' losses is the
    batch's loss, and the accumulated gradient the batch's gradient."""
    _, tcfg, _, tparams = smoke
    kw = dict(ACCUM[mode])
    accum = kw.pop("accum_in_loss", False)
    tokens = _tokens(8, b=4)
    base = dict(global_batch_size=4, seq_len=32, total_steps=3,
                warmup_steps=1)
    _, one, m1 = _one_step(S.make_train_step(tcfg, TrainConfig(**base),
                                             backend="flash"),
                           tparams, tokens)
    _, acc, m2 = _one_step(S.make_train_step(
        tcfg, TrainConfig(**base, **kw), backend="flash",
        accum_in_loss=accum), tparams, tokens)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    _assert_grads_close(_leaves(acc.mu), {
        k: v.numpy() for k, v in _leaves(one.mu).items()})


def test_microbatch_must_divide_the_batch(smoke):
    _, tcfg, _, tparams = smoke
    step = S.make_train_step(tcfg, TrainConfig(microbatch=3),
                             backend="xla")
    with pytest.raises(ValueError, match="microbatches"):
        _one_step(step, tparams, _tokens(1, b=4))


# ------------------------------------------------ checkpoint and resume
TRAIN_KW = dict(steps=6, batch=2, seq=32, smoke=True, attn_backend="xla",
                lr=1e-3, seed=7, device="cpu", save_interval=2)


def test_train_checkpoint_restart_matches_uninterrupted(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run (the port's
    counterpart of tests/test_integration.py's fault-tolerance
    contract), with 2 microbatches a step."""
    params_a, losses_a = train("moba-340m", ckpt_dir=str(tmp_path / "a"),
                               microbatch=2, **TRAIN_KW)
    d2 = str(tmp_path / "b")
    _, first = train("moba-340m", ckpt_dir=d2, microbatch=2,
                     stop_at_step=3, **TRAIN_KW)
    params_b, losses_b = train("moba-340m", ckpt_dir=d2, resume="auto",
                               microbatch=2, **TRAIN_KW)
    assert len(first) == 3 and len(losses_b) == 3
    np.testing.assert_allclose(losses_a, first + losses_b, rtol=1e-5)
    a, b = _leaves(params_a), _leaves(params_b)
    for name in a:
        np.testing.assert_allclose(b[name].detach().numpy(),
                                   a[name].detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # saved at steps 2, 3 (the stop) and 4, 6; the last 3 kept
    assert sorted(os.listdir(d2)) == ["step_00000003", "step_00000004",
                                      "step_00000006"]


def test_port_resumes_from_jax_checkpoint(tmp_path):
    """The JAX trainer writes a checkpoint at step 2; the port restores
    it and its next step's loss matches the JAX trainer's step 2."""
    from repro.launch.train import train as jtrain
    jkw = {k: v for k, v in TRAIN_KW.items() if k != "device"}
    d = str(tmp_path / "jax")
    jtrain("moba-340m", ckpt_dir=d, stop_at_step=2, log_every=100, **jkw)
    _, jlosses = jtrain("moba-340m", stop_at_step=3, log_every=100, **jkw)
    _, losses = train("moba-340m", ckpt_dir=d, resume="auto",
                      stop_at_step=3, **TRAIN_KW)
    assert len(losses) == 1
    np.testing.assert_allclose(losses[0], jlosses[2], atol=2e-4, rtol=2e-4)


def test_train_cli_checkpoint_resume_microbatch(tmp_path):
    args = ("--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--resume",
            "auto", "--microbatch", "2", "--save-interval", "1")
    res = _cli(*args)
    assert res.returncode == 0, res.stderr
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]
    res = _cli(*args[:2], "3", *args[3:])
    assert res.returncode == 0, res.stderr
    assert "[resume] restored step 2" in res.stdout
    assert res.stdout.count("loss") == 1          # step 2 only
