"""The vision family (llama-3.2-vision-90b: the ``cross`` kind) in the
port against the JAX package, on the same numpy inputs and converted
weights: the shared cases of ``crossattn_cases.py``, and the cross
slot's rules (no RoPE, no cache, dense and unmasked onto the image
embeddings; causal self attention when given none, as in JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossattn_cases import (  # noqa: F401  (collected here)
    close, smoke, jax_fixed, test_accumulated_step_matches_jax,
    test_batch_mode_serves_through_the_fixed_loop,
    test_checkpoints_cross_both_ways, test_dense_caches_layout,
    test_engine_and_paged_caches_refuse, test_engine_modes_exit_2,
    test_lm_apply_with_cross_kv_equals_jax, test_loss_and_grads_equal_jax,
    test_serve_fixed_equals_jax, test_smoke_param_trees_equal_jax,
    test_train_losses_equal_jax)
from repro.models import transformer as JT
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def arch():
    return "llama-3.2-vision-90b"


def test_cross_slot_takes_no_rope_and_sees_every_image_token(smoke):
    """The cross slot's output at a query does not depend on its
    position, and editing the last image token moves every query."""
    _, tcfg, _, _, tparams = smoke
    p = {k: v[0] for k, v in tparams["blocks"]["slot_1"]["attn"].items()}
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    mem = torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32))
    a, ca = L.apply_attention(p, x, tcfg, "cross", cross_kv=mem)
    b, cb = L.apply_attention(p, x, tcfg, "cross", cross_kv=mem,
                              positions=torch.arange(5) + 100)
    assert ca is None and cb is None
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    edited = mem.clone()
    edited[:, -1] += 5.0
    c, _ = L.apply_attention(p, x, tcfg, "cross", cross_kv=edited)
    assert float((c - a).abs().amax(-1).min()) > 1e-3


def test_lm_apply_without_cross_kv_equals_jax(smoke):
    """Given no image embeddings, a cross slot attends causally onto its
    own input, as JAX's does."""
    jcfg, tcfg, jparams, _, tparams = smoke
    tokens = np.random.default_rng(9).integers(0, 256, (2, 24)).astype(
        np.int32)
    want, _, _ = JT.lm_apply(jparams, jnp.asarray(tokens), jcfg)
    got, _, _ = TT.lm_apply(tparams, torch.from_numpy(tokens), tcfg)
    close(got, want, 2e-4, "logits")
