"""Sequence- and context-parallel MoBA in the PyTorch port
(``distributed/moba_sp.py``) against the JAX package, every shard on the
CPU.

* ``moba_attention_sp`` over 2 and 4 shards against the reference's
  ``moba_attention_reference``, and ``moba_decode_cp`` against its
  single-device ``moba_decode_attention``, in-process on numpy inputs at
  the reference's tolerance (``tests/test_distributed.py``: 3e-4), with
  the distributed selection bit-equal to ``lax.top_k`` on the
  single-device scores: ``kv_len`` 256, 200 and 130, with and without the
  centroid cache, fewer local blocks than ``top_k``, an awkward cache
  length that falls back;
* one JAX subprocess on 8 simulated devices (the only one in this file
  and ``test_torch_sharded.py``) runs the reference's ``moba_decode_cp``
  and ``moba_attention_sp`` under a mesh and a 2-shard ``ShardedEngine``
  with the prefix cache on a fixed request set (a shared prefix, one
  request longer than a shard's pool); the port's outputs, streams,
  shard assignments, per-shard request counts, prefix hits and ``cp_*``
  counters must equal it;
* a context-parallel cache holds its MoBA K/V and centroids as one
  segment per shard, each its own storage on its shard's device, and a
  decode step moves between shards exactly the bytes of
  ``cp_decode_bytes`` plus the appended token.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import moba as JM
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoBAConfig
from repro_torch.convert import from_jax
from repro_torch.distributed import moba_sp as SP
from repro_torch.models import transformer as T
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.sharded import ShardedEngine
from test_torch_fixed import _jax_selection
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=3e-4, atol=3e-4)        # tests/test_distributed.py:44-45
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _t(x):
    return torch.from_numpy(np.array(x))


def _group(tp):
    return SP.CPGroup(["cpu"] * tp)


# ------------------------------------------------------------ SP prefill
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", ["fresh", "suffix", "positions", "ragged"])
def test_moba_attention_sp_equals_jax(tp, case):
    """Queries split over ``tp`` shards, K/V copied to each: equal to the
    reference's oracle on the same inputs.  ``suffix``: the queries are
    the last 48 of 96 keys; ``positions``: explicit query positions
    (honoured per shard); ``ragged``: Nq not a multiple of tp, the plain
    path."""
    nq, n = {"fresh": (96, 96), "suffix": (48, 96), "positions": (48, 96),
             "ragged": (33, 96)}[case]
    rng = np.random.default_rng(tp * 10 + len(case))
    q = rng.normal(size=(1, 4, nq, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, n, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, n, 16)).astype(np.float32)
    pos = np.arange(nq) + (n - nq)
    if case == "positions":
        pos = np.sort(rng.choice(n, nq, replace=False))
    want = JM.moba_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        JMoBAConfig(block_size=16, top_k=3), q_positions=jnp.asarray(pos))
    g = _group(tp)
    got = SP.moba_attention_sp(
        _t(q), _t(k), _t(v), MoBAConfig(block_size=16, top_k=3),
        q_positions=_t(pos) if case == "positions" else None, group=g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    split = case != "ragged"
    assert (g.bytes["kv"] == 2 * (tp - 1) * k.nbytes) is split


# ------------------------------------------------------------- CP decode
DECODE = {
    # id: (nmax, kv_len, centroid cache, tp); block 16, top_k 5: 16
    # blocks, so 4 shards hold 4 < top_k each
    "kv256": (256, 256, False, 2),
    "kv200-tp4": (256, 200, False, 4),
    "kv130-cents": (256, 130, True, 2),
    "kv130-tp4-cents": (256, 130, True, 4),
    "kv1": (256, 1, False, 2),
    "awkward-fallback": (208, 200, False, 4),            # 208 % 64 != 0
}


@pytest.mark.parametrize("case", sorted(DECODE))
def test_moba_decode_cp_equals_jax(case):
    nmax, kvl, with_cents, tp = DECODE[case]
    bs, top_k = 16, 5
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, nmax, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, nmax, 16)).astype(np.float32)
    k[:, :, kvl:] = v[:, :, kvl:] = 0.0          # unwritten cache rows
    jcfg = JMoBAConfig(block_size=bs, top_k=top_k)
    cfg = MoBAConfig(block_size=bs, top_k=top_k)
    cents = None
    if with_cents:
        from repro.core import routing as JR
        cents = np.array(JR.block_centroids(jnp.asarray(k), bs, kv_len=kvl))
    want = JM.moba_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(kvl),
        jcfg, centroids=None if cents is None else jnp.asarray(cents))
    g = _group(tp)
    got = SP.moba_decode_cp(_t(q), _t(k), _t(v), kvl, cfg,
                            centroids=None if cents is None else _t(cents),
                            group=g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "awkward-fallback":
        assert not g.bytes                      # nothing was split
        return
    w_idx, w_valid, _ = _jax_selection(
        jnp.asarray(q), jnp.asarray(k), kvl, jcfg,
        None if cents is None else jnp.asarray(cents))
    k_segs = SP.split_segments(_t(k), g)
    c_segs = None if cents is None else SP.split_segments(_t(cents), g)
    sel = SP.cp_select(_t(q), k_segs, kvl, cfg, c_segs=c_segs, group=g)
    for ids, valid in sel:          # every shard's copy of the selection
        np.testing.assert_array_equal(valid.numpy(), w_valid[:, :, :, 0])
        np.testing.assert_array_equal(
            torch.where(valid, ids, 0).numpy(), w_idx[:, :, :, 0])


def test_cp_step_bytes_equal_formula():
    """One decode call over segments moves exactly ``cp_decode_bytes``:
    the query, the candidates, the partials; the cache stays put."""
    tp, cfg = 4, MoBAConfig(block_size=16, top_k=3)
    rng = np.random.default_rng(5)
    q = _t(rng.normal(size=(2, 4, 1, 16)).astype(np.float32))
    k = _t(rng.normal(size=(2, 2, 256, 16)).astype(np.float32))
    g = _group(tp)
    k_segs, v_segs = SP.split_segments(k, g), SP.split_segments(k, g)
    g.bytes.clear()
    SP.moba_decode_cp(q, k_segs, v_segs, 200, cfg, group=g)
    want = SP.cp_decode_bytes(2, 4, 16, 3, tp, 4)
    assert dict(g.bytes) == want
    assert want == {"q": 3 * 2 * 4 * 16 * 4, "candidates": 12 * 2 * 4 * 3 * 8,
                    "partials": 3 * 2 * 4 * 18 * 4}


# ------------------------------------------------------ the engine's CP
@pytest.fixture(scope="module")
def smoke():
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import transformer as JT
    jcfg = jax_smoke_config("moba-340m")
    cfg = get_smoke_config("moba-340m")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return cfg, from_jax(jax.tree.map(np.asarray, jparams), cfg,
                         device="cpu")


def test_cp_cache_segments_live_on_their_shards(smoke):
    """A context-parallel request's MoBA slot holds k, v and centroids as
    one segment per shard, each its own storage (not a view of one whole
    cache) on the shard's device; a decode step moves the formula's bytes
    plus the new token's K/V to its owner, and the appended token lands
    in the owning segment."""
    cfg, params = smoke
    devs = [torch.device("cpu")] * 2
    caches = T.init_caches(cfg, 1, 128, dtype=torch.float32, device="cpu",
                           segments=devs)
    moba = caches["slot_1"]                    # pattern (swa, moba)
    assert isinstance(caches["slot_0"]["k"], torch.Tensor)
    for name, n in (("k", 64), ("v", 64), ("centroids", 4)):
        segs = moba[name]
        assert len(segs) == 2
        assert [x.device for x in segs] == devs
        assert all(x.shape[-2] == n for x in segs)
        assert all(x.untyped_storage().nbytes() == x.numel()
                   * x.element_size() for x in segs)
        assert segs[0].untyped_storage().data_ptr() \
            != segs[1].untyped_storage().data_ptr()
    from repro_torch.launch import steps as S
    g = SP.CPGroup(devs)
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, 256, (1, 70)), dtype=torch.int32)
    with SP.use_group(g):
        logits, caches = S.make_prefill_step(cfg, backend="sp")(
            params, prompt, caches)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        g.bytes.clear()
        _, caches = S.make_decode_step(cfg, backend="sp")(params, tok,
                                                           caches)
    b, h, d = 1, cfg.num_heads, cfg.resolved_head_dim
    want = SP.cp_decode_bytes(b, h, d, cfg.attention.moba.top_k, 2, 4)
    groups = cfg.num_layers // len(cfg.layer_pattern)
    want = {k: n * groups for k, n in want.items()}
    want["append"] = 2 * cfg.num_kv_heads * d * 4 * groups   # position 70
    assert dict(g.bytes) == want
    seg1 = caches["slot_1"]["k"][1]
    assert seg1[:, :, :, 70 - 64].abs().sum() > 0       # the new token
    assert seg1[:, :, :, 71 - 64:].abs().sum() == 0


_JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import MoBAConfig, ShardingConfig
from repro.distributed import sharding as shmod
from repro.distributed.moba_sp import moba_attention_sp, moba_decode_cp
from repro.models import transformer as T
from repro.serving.engine import EngineConfig
from repro.serving.sharded import ShardedEngine

out = {}
rng = np.random.default_rng(11)
scfg = ShardingConfig(fsdp=False, tensor_parallel=False,
                      sequence_parallel=False)
cfg = MoBAConfig(block_size=16, top_k=3)
for tp in (2, 4):
    mesh = shmod.make_compat_mesh((1, tp), ("data", "model"))
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 256, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 256, 16)).astype(np.float32)
    qs = rng.normal(size=(1, 4, 96, 16)).astype(np.float32)
    ks = rng.normal(size=(1, 2, 96, 16)).astype(np.float32)
    vs = rng.normal(size=(1, 2, 96, 16)).astype(np.float32)
    out.update({f"q{tp}": q, f"k{tp}": k, f"v{tp}": v, f"qs{tp}": qs,
                f"ks{tp}": ks, f"vs{tp}": vs})
    dec = jax.jit(lambda q, k, v, n: moba_decode_cp(q, k, v, n, cfg))
    with shmod.use_mesh(mesh, scfg):
        for n in (256, 200, 130):
            out[f"dec{tp}_{n}"] = np.asarray(dec(q, k, v, jnp.int32(n)))
        out[f"sp{tp}"] = np.asarray(jax.jit(
            lambda q, k, v: moba_attention_sp(q, k, v, cfg))(qs, ks, vs))

mcfg = get_smoke_config("moba-340m")
params = T.init_lm(jax.random.PRNGKey(0), mcfg)
sh = ShardedEngine(mcfg, params, EngineConfig(max_seqs=2, max_seq_len=64,
                                              prefix_cache=True),
                   n_shards=2)
shared = rng.integers(0, mcfg.vocab_size, 32, dtype=np.int32)
mk = lambda n: np.concatenate(
    [shared, rng.integers(0, mcfg.vocab_size, n, dtype=np.int32)])
prompts = [mk(9), mk(12), mk(5),
           rng.integers(0, mcfg.vocab_size, 20, dtype=np.int32),
           rng.integers(0, mcfg.vocab_size, 101, dtype=np.int32)]
gens = [6, 6, 6, 6, 8]
reqs = [sh.submit(prompts[0], gens[0])]
sh.run()                      # the shared prefix is cached before the rest
reqs += [sh.submit(p, g) for p, g in zip(prompts[1:], gens[1:])]
sh.run()
for i, r in enumerate(reqs):
    out[f"prompt{i}"], out[f"out{i}"] = r.prompt, np.asarray(r.out)
    out[f"shard{i}"] = r.shard
out["gens"] = np.asarray(gens)
out["shard_requests"] = np.asarray([s["requests"] for s in sh.shard_stats])
for key in ("prefix_hits", "prefix_hit_tokens", "cp_requests", "cp_tokens"):
    out[key] = sh.stats[key]
out["cp_s_positive"] = sh.stats["cp_s"] > 0
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """The reference's sharded functions and engine on 8 simulated
    devices, in one subprocess (the device count is fixed at JAX's
    start), started before this file's first test so that it runs while
    the in-process tests do.  The CP request's prompt is odd: the
    reference's SP prefill places the queries at the END of the whole
    dense cache it is handed, ignoring their positions (ROADMAP.md §C),
    and an odd prompt on 2 shards takes its plain path, which places them
    right.  The port's prefill hands SP only the valid prefix, and
    ``test_moba_attention_sp_equals_jax`` holds it to the oracle."""
    path = tmp_path_factory.mktemp("jax_sharded") / "out.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c",
                             textwrap.dedent(_JAX_CODE), str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_run(jax_proc):
    proc, path = jax_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("tp", [2, 4])
def test_cp_functions_equal_jax_mesh(jax_run, tp):
    j = jax_run
    cfg = MoBAConfig(block_size=16, top_k=3)
    g = _group(tp)
    for n in (256, 200, 130):
        got = SP.moba_decode_cp(_t(j[f"q{tp}"]), _t(j[f"k{tp}"]),
                                _t(j[f"v{tp}"]), n, cfg, group=g)
        np.testing.assert_allclose(got.numpy(), j[f"dec{tp}_{n}"], **TOL)
    got = SP.moba_attention_sp(_t(j[f"qs{tp}"]), _t(j[f"ks{tp}"]),
                               _t(j[f"vs{tp}"]), cfg, group=g)
    np.testing.assert_allclose(got.numpy(), j[f"sp{tp}"], **TOL)


def test_sharded_engine_equals_jax_engine(jax_run, smoke):
    """The same request set through the port's 2-shard engine: streams,
    shard assignments (prefix affinity sends the shared-prefix requests
    to the first one's shard; the long one goes to the CP fallback),
    per-shard request counts, prefix hits and ``cp_*`` counters."""
    j = jax_run
    cfg, params = smoke
    sh = ShardedEngine(cfg, params, EngineConfig(
        max_seqs=2, max_seq_len=64, prefix_cache=True), n_shards=2,
        devices=["cpu", "cpu"])
    gens = [int(x) for x in j["gens"]]
    reqs = [sh.submit(j["prompt0"], gens[0])]
    sh.run()
    reqs += [sh.submit(j[f"prompt{i}"], gens[i]) for i in range(1, 5)]
    sh.run()
    for i, r in enumerate(reqs):
        assert r.out == list(j[f"out{i}"]), i
        assert r.shard == int(j[f"shard{i}"]), i
    assert [s["requests"] for s in sh.shard_stats] \
        == list(j["shard_requests"])
    for key in ("prefix_hits", "prefix_hit_tokens", "cp_requests",
                "cp_tokens"):
        assert sh.stats[key] == int(j[key]), key
    assert sh.stats["prefix_hits"] > 0 and sh.stats["cp_requests"] == 1
    assert (sh.stats["cp_s"] > 0) == bool(j["cp_s_positive"])
    rec = sh.cp_record
    assert rec["decode_steps"] == gens[4] - 1
    assert set(rec["decode_bytes"]) == {"q", "candidates", "partials",
                                        "append"}
