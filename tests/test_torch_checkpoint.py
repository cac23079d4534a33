"""The port's checkpoint manager: the reference's behaviour
(tests/test_substrates.py: round trip and retention, atomicity, async
writes, shape mismatch) and its on-disk format, which both packages'
managers read: a checkpoint written by the JAX ``CheckpointManager``
restores into the port's tree and the reverse, leaf for leaf, on the
trainer's own ``{"params", "mu", "nu"}`` tree.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.optim import adamw as JADAM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.optim import adamw
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_writes=False)
    tree = _tree()
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"data_step": step})
    assert mgr.all_steps() == [2, 3]  # retention keeps last 2
    template = {"a": torch.zeros(2, 3),
                "nested": {"b": torch.zeros(4, dtype=torch.int32)}}
    restored, extra, step = mgr.restore(template)
    assert step == 3 and extra["data_step"] == 3
    torch.testing.assert_close(restored["a"], tree["a"])
    assert restored["nested"]["b"].dtype == torch.int32
    torch.testing.assert_close(restored["nested"]["b"], tree["nested"]["b"])
    restored, _, step = mgr.restore(template, step=2)
    assert step == 2


def test_checkpoint_atomicity(tmp_path):
    """A tmp dir left by a crashed save must not be listed as a step."""
    mgr = CheckpointManager(str(tmp_path), async_writes=False)
    os.makedirs(tmp_path / "tmp.step_00000009")
    mgr.save(1, {"x": torch.zeros(2)})
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_writes=True)
    mgr.save(5, {"x": torch.full((8,), 2.0)})
    mgr.wait()
    restored, _, step = mgr.restore({"x": torch.zeros(8)})
    assert step == 5
    torch.testing.assert_close(restored["x"], torch.full((8,), 2.0))


def test_checkpoint_async_snapshot_precedes_in_place_update(tmp_path):
    """``save`` copies the tensors before it returns: the optimizer's
    in-place update right after it cannot reach the queued write."""
    mgr = CheckpointManager(str(tmp_path), async_writes=True)
    x = torch.full((1 << 16,), 3.0)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    restored, _, _ = mgr.restore({"x": torch.zeros_like(x)})
    assert bool((restored["x"] == 3.0).all())


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_writes=False)
    mgr.save(1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"x": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"y": torch.zeros(4)})


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path), async_writes=False).restore(
            {"x": torch.zeros(1)})


# ------------------------------------------------ across the two packages
@pytest.fixture(scope="module")
def trees():
    """The trainer's checkpoint tree in both packages, with random
    moments: the JAX tree and the port's conversion of it."""
    jcfg = jax_smoke_config("moba-340m")
    cfg = get_smoke_config("moba-340m")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jstate = JADAM.adamw_init(jparams)
    mu = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), jstate.mu)
    nu = jax.tree.map(lambda a: jnp.asarray(
        rng.random(size=a.shape).astype(np.float32)), jstate.nu)
    jtree = {"params": jparams, "mu": mu, "nu": nu}
    tree = {k: from_jax(jax.tree.map(np.asarray, v), cfg, device="cpu")
            for k, v in jtree.items()}
    return jtree, tree


def _jax_named(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_leaf_paths_are_jax_tree_paths(trees, tmp_path):
    jtree, tree = trees
    CheckpointManager(str(tmp_path), async_writes=False).save(4, tree)
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["paths"] == list(_jax_named(jtree))
    assert set(manifest["dtypes"]) == {"float32"}


def test_jax_checkpoint_restores_into_port(trees, tmp_path):
    jtree, tree = trees
    JManager(str(tmp_path), async_writes=False).save(
        7, jtree, extra={"data_step": 7})
    template = jax.tree.map(torch.zeros_like, tree)
    got, extra, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 7 and extra == {"data_step": 7}
    want = _jax_named(jtree)
    for name, leaf in adamw.tree_leaves(got):
        np.testing.assert_array_equal(leaf.numpy(), want[name],
                                      err_msg=name)


def test_port_checkpoint_restores_into_jax(trees, tmp_path):
    jtree, tree = trees
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree, extra={"data_step": 3, "arch": "moba-340m"})
    mgr.wait()
    template = jax.tree.map(jnp.zeros_like, jtree)
    got, extra, step = JManager(str(tmp_path),
                                async_writes=False).restore(template)
    assert step == 3 and extra["arch"] == "moba-340m"
    want = dict(adamw.tree_leaves(tree))
    for name, leaf in _jax_named(got).items():
        np.testing.assert_array_equal(leaf, want[name].numpy(),
                                      err_msg=name)
