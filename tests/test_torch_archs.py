"""The dense-family architectures of the port's config registry against
the JAX package's: the configs themselves, the full-size parameter
trees (read through ``jax.eval_shape``, so nothing is allocated), the
smoke models' loss and gradients on ``flash`` (on CPU tensors its
kernels' plain versions), and greedy ``flash`` engine tokens; and the
port's copy of the NIAH data generator.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import niah as JN
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import configs as TC
from repro_torch.convert import from_jax
from repro_torch.data import niah as TN
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.serving.engine import Engine, EngineConfig

ARCHS = ("moba-1b", "qwen3-0.6b", "qwen3-14b", "internlm2-1.8b",
         "codeqwen1.5-7b")
# get_config variants: the paper's options and the dense baselines
VARIANTS = {
    "moba-1b": [dict(), dict(key_conv_width=3), dict(dense_baseline=True),
                dict(block_size=32, top_k=32)],
    **{a: [dict(), dict(key_conv_width=3), dict(moba=False)]
       for a in ARCHS[1:]},
}


@pytest.mark.parametrize("arch", ARCHS)
def test_registered_and_configs_equal_jax(arch):
    assert arch in TC.ARCHS and TC.ARCHS[arch] == JC.ARCHS[arch]
    for kw in VARIANTS[arch]:
        assert dataclasses.asdict(TC.get_config(arch, **kw)) == \
            dataclasses.asdict(JC.get_config(arch, **kw)), kw
    assert dataclasses.asdict(TC.get_smoke_config(arch)) == \
        dataclasses.asdict(JC.get_smoke_config(arch))


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_jax_init_at_full_size(arch):
    for kw in (dict(), dict(key_conv_width=3)):
        jcfg = JC.get_config(arch, **kw)
        want = _shapes(jax.eval_shape(
            lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg)))
        got = TT.param_shapes(TC.get_config(arch, **kw))
        assert got == want, kw


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    arch = request.param
    jcfg = JC.get_smoke_config(arch)
    tcfg = TC.get_smoke_config(arch)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_smoke_loss_and_grads_match_jax(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    tokens = np.random.default_rng(1).integers(0, 256, (2, 33)).astype(
        np.int32)
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(JT.lm_loss, has_aux=True),
        static_argnums=(2, 3))(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, "flash")
    leaves = [leaf.detach().requires_grad_() for _, leaf in
              adamw.tree_leaves(tparams)]
    params = adamw.tree_like(tparams, leaves)
    loss, _ = TT.lm_loss(params, {"tokens": torch.from_numpy(tokens)},
                         tcfg, backend="flash")
    grads = dict(adamw.tree_leaves(adamw.tree_like(
        params, torch.autograd.grad(loss, leaves))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=2e-4, rtol=2e-4)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(grads) == set(want)
    for name, w in want.items():
        err = float(np.abs(grads[name].numpy() - w).max())
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)


def test_flash_engine_tokens_equal_jax(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (40, 33, 21)]
    ecfg = dict(max_seqs=3, max_seq_len=64, attn_backend="flash")
    outs = []
    for eng in (Engine(tcfg, tparams, EngineConfig(**ecfg), device="cpu"),
                JEngine(jcfg, jparams, JEngineConfig(**ecfg))):
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run()
        outs.append([list(r.out) for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", [0, 7])
def test_niah_batches_equal_jax(seed):
    want = JN.make_niah_batch(np.random.default_rng(seed), 3, 200, 256)
    got = TN.make_niah_batch(np.random.default_rng(seed), 3, 200, 256)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    sel = np.random.default_rng(seed).integers(0, 13, (3, 4))
    assert TN.router_retrieval_accuracy(sel, got["needle_pos"], 16) == \
        JN.router_retrieval_accuracy(sel, want["needle_pos"], 16)
