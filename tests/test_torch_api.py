"""The port's model-level API (``repro_torch.models.api``) and
``launch/steps.py::model_flops`` against the JAX package's.

The parameter counts must equal ``repro.models.api``'s for every config
at full size without allocating a tensor (llama-3.2-vision-90b is ~88 B
parameters), and ``model_flops`` must equal ``repro.launch.steps``'s
for every config and assigned shape.  ``make_forward``'s logits match
JAX's at smoke size on converted weights within fp32 2e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import steps as JSTEPS
from repro.models import api as JAPI
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.convert import from_jax
from repro_torch.launch import steps as S
from repro_torch.models import api as API
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = sorted(TC.ARCHS)
SHAPES = sorted(TC.ASSIGNED_SHAPES)
TOL = 2e-4


def test_every_config_and_shape_is_covered():
    assert len(ARCHS) == 12 and sorted(JC.ARCHS) == ARCHS
    assert TC.ASSIGNED_SHAPES == JC.ASSIGNED_SHAPES and len(SHAPES) == 4


@pytest.fixture(scope="module")
def jax_counts():
    """{arch: (param_count, active_param_count, {shape: model_flops})}
    from the JAX package, each config's counts traced once
    (``model_flops`` reads the cached active count)."""
    out = {}
    active = functools.lru_cache(maxsize=None)(JAPI.active_param_count)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSTEPS.api, "active_param_count", active)
        for arch in ARCHS:
            cfg = JC.get_config(arch)
            out[arch] = (JAPI.param_count(cfg), active(cfg),
                         {s: JSTEPS.model_flops(cfg, s) for s in SHAPES})
    return out


@pytest.fixture
def no_allocation(monkeypatch):
    """Any tensor the counts would build raises."""
    def refuse(*a, **kw):
        raise AssertionError("a parameter count allocated a tensor")
    for name in ("randn", "ones", "zeros", "empty", "full", "tensor",
                 "as_tensor", "arange"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(TT, "init_lm", refuse)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch, jax_counts, no_allocation):
    cfg = TC.get_config(arch)
    want_total, want_active, _ = jax_counts[arch]
    assert API.param_count(cfg) == want_total
    assert API.active_param_count(cfg) == want_active
    assert (want_active < want_total) == (cfg.family == "moe")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch, shape, jax_counts, no_allocation):
    got = S.model_flops(TC.get_config(arch), shape)
    assert got == jax_counts[arch][2][shape]
    assert got > 0


def test_model_flops_formula():
    """6·N·D for training, 2·N·D for a forward pass; decode counts one
    token a sequence; an untied embedding table is not counted."""
    cfg = TC.get_config("moba-340m")
    n = API.active_param_count(cfg) - cfg.vocab_size * cfg.d_model
    assert not cfg.tie_embeddings
    assert S.model_flops(cfg, "train_4k") == 6.0 * n * 4096 * 256
    assert S.model_flops(cfg, "prefill_32k") == 2.0 * n * 32768 * 32
    assert S.model_flops(cfg, "decode_32k") == 2.0 * n * 128
    tied = TC.get_config("qwen3-0.6b")
    assert tied.tie_embeddings
    assert S.model_flops(tied, "long_500k") == \
        2.0 * API.active_param_count(tied)


# (arch, the stub input the forward takes, its length)
FORWARD_CASES = [("moba-340m", None, 0),
                 ("seamless-m4t-medium", "src_embeds", 64),
                 ("llama-3.2-vision-90b", "cross_kv", 8)]


@pytest.mark.parametrize("arch,extra,m", FORWARD_CASES)
def test_make_forward_logits_equal_jax(arch, extra, m):
    """``make_forward(cfg)`` (the ``sparse`` backend) on 2 × 64 tokens:
    64 keys of block 16 with top_k 2, so every MoBA layer routes; the
    encoder of seamless runs over 64 frames of ``src_embeds``."""
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 64), dtype=np.int32)
    kw = ({} if extra is None else
          {extra: rng.normal(0, 1, (2, m, tcfg.d_model)).astype(np.float32)})
    want = jax.jit(JAPI.make_forward(jcfg))(
        jparams, jnp.asarray(tokens),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = API.make_forward(tcfg)(
            params, torch.as_tensor(tokens),
            **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert got.shape == (2, 64, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if extra is not None:      # the stub input reaches the logits
        kw[extra] = kw[extra] + 1.0
        with torch.no_grad():
            moved = API.make_forward(tcfg)(
                params, torch.as_tensor(tokens),
                **{k: torch.as_tensor(v) for k, v in kw.items()})
        assert float((moved - got).abs().max()) > 1e-3
