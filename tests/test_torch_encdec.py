"""The encoder-decoder family (seamless-m4t-medium: the ``decoder`` kind
and ``apply_encoder``) in the port against the JAX package, on the same
numpy inputs and converted weights: the shared cases of
``crossattn_cases.py``, the encoder under every backend, and the
encoder's causal MoBA.

The config calls its encoder bidirectional, but MoBA prefill reads
``MoBAConfig.causal`` (True) and ignores the encoder's ``causal=False``
in both packages: a later frame never reaches an earlier one.  The dense
encoder (``moba=False``) is bidirectional.  The port follows the code
(ROADMAP.md §C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossattn_cases import (  # noqa: F401  (collected here)
    BACKENDS, close, smoke, jax_fixed, test_accumulated_step_matches_jax,
    test_batch_mode_serves_through_the_fixed_loop,
    test_checkpoints_cross_both_ways, test_dense_caches_layout,
    test_engine_and_paged_caches_refuse, test_engine_modes_exit_2,
    test_lm_apply_with_cross_kv_equals_jax, test_loss_and_grads_equal_jax,
    test_serve_fixed_equals_jax, test_smoke_param_trees_equal_jax,
    test_train_losses_equal_jax)
from repro import configs as JC
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.convert import from_jax
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def arch():
    return ARCH


def _frames(seed=5):
    return np.random.default_rng(seed).normal(size=(2, 32, 64)).astype(
        np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
def test_apply_encoder_equals_jax(smoke, backend):
    jcfg, tcfg, jparams, _, tparams = smoke
    src = _frames()
    want = JT.apply_encoder(jparams, jnp.asarray(src), jcfg,
                            backend=backend)
    got = TT.apply_encoder(tparams, torch.from_numpy(src), tcfg,
                           backend=backend)
    assert got.shape == (2, 32, 64) and got.dtype == torch.float32
    close(got, want, 2e-4, backend)


@pytest.mark.parametrize("moba", [True, False])
def test_encoder_is_causal_moba(moba):
    """Adding 5.0 to the last of 32 frames: with MoBA, frame 0's encoder
    output is bit-unchanged in both packages (every backend of the
    port); the dense encoder moves it."""
    jcfg = JC.get_smoke_config(ARCH, moba=moba)
    tcfg = TC.get_smoke_config(ARCH, moba=moba)
    jparams = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                       device="cpu")
    src = _frames(6)
    edited = src.copy()
    edited[:, -1] += 5.0
    outs = [np.asarray(JT.apply_encoder(jparams, jnp.asarray(x), jcfg))
            for x in (src, edited)]
    outs += [TT.apply_encoder(tparams, torch.from_numpy(x), tcfg,
                              backend=b).numpy()
             for b in BACKENDS for x in (src, edited)]
    for a, b in zip(outs[::2], outs[1::2]):
        moved = float(np.abs(a[:, 0] - b[:, 0]).max())
        assert (moved == 0.0) if moba else (moved > 1e-2), moved
        assert float(np.abs(a[:, -1] - b[:, -1]).max()) > 1e-2


def test_decoder_self_attention_takes_no_key_conv():
    """With kconv3, only the encoder's MoBA attention convolves keys: a
    ``decoder`` slot's self attention is built as its own kind, as in
    the reference's ``init_attention``."""
    shapes = TT.param_shapes(TC.get_config(ARCH, key_conv_width=3))
    assert shapes["encoder"]["blocks"]["attn"]["key_conv"] == (12, 3, 16,
                                                               64)
    dec = shapes["blocks"]["slot_0"]
    assert "key_conv" not in dec["attn"] and "key_conv" not in dec["cross"]
    assert dec["norm_cross"] == (12, 1024)
