"""The PyTorch port's sharded serving engine (``serving/sharded.py``)
against the JAX package, every shard on the CPU.

* Greedy streams of the port's ``ShardedEngine`` on 2 and 4 shards equal
  the JAX single-host ``Engine``'s on the smoke moba-340m config with
  converted weights (the reference pins its own sharded engine to its
  single-host one, ``tests/test_sharded_serving.py``): under
  ``reference``, ``xla``, ``flash`` (on CPU tensors its kernels' plain
  versions), ``sharded``, kconv3 with chunked prefill, an int8 pool,
  preemption replay on starved per-shard pools, and the staged API with
  decode dispatched ahead.
* ``Router.pick`` equals the reference's on the same scheduler states,
  prefix affinity included; ``prefill_bucket`` is shard-invariant.
* A hypothesis property: streams do not change with the shard count (1,
  2 or 4) or the submission order.
* ``--shards`` reaches ``serve``, ``serve_stream``, ``serve_openloop``
  and the CLI with per-shard metrics; more shards than cards raise.
* The ``sp``, ``sp_unrolled`` and ``sharded`` backends' capabilities
  equal the reference's, and ``sync_docs`` rewrites a file's marked
  block.
"""
import contextlib
import dataclasses
import io

import hypothesis
import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import backends as JB
from repro.models import transformer as JT
from repro.serving import scheduler as JSch
from repro.serving import sharded as JSh
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import prefill_bucket as j_prefill_bucket
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.core import backends as B
from repro_torch.launch import serve as TS
from repro_torch.serving import frontend as FE
from repro_torch.serving import scheduler as TSch
from repro_torch.serving.engine import Engine, EngineConfig, prefill_bucket
from repro_torch.serving.scheduler import (ServingError,
                                           UnsupportedFeatureError)
from repro_torch.serving.sharded import Router, ShardedEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROMPT_LENS, GEN = (40, 35, 30, 38), 12


def _prompts(lens=PROMPT_LENS, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.int32) for n in lens]


@pytest.fixture(scope="module")
def models():
    """{variant: (port cfg, port params, JAX cfg, JAX params)}: the smoke
    moba-340m and its kconv3 twin, one set of weights for both packages."""
    out = {}
    for name, kw in (("plain", {}), ("kconv3", {"key_conv_width": 3})):
        jcfg = jax_smoke_config("moba-340m", **kw)
        cfg = get_smoke_config("moba-340m", **kw)
        jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        out[name] = (cfg, from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu"), jcfg, jparams)
    return out


_JAX_WANT = {}


def _jax_streams(models, variant, kv_dtype):
    """The JAX single-host engine's streams on :data:`PROMPT_LENS`, with
    room for every request (``reference``; ``xla`` for int8 pools)."""
    key = (variant, kv_dtype)
    if key not in _JAX_WANT:
        _, _, jcfg, jparams = models[variant]
        eng = JEngine(jcfg, jparams, JEngineConfig(
            max_seqs=4, max_seq_len=64, kv_dtype=kv_dtype,
            attn_backend="xla" if kv_dtype != "fp32" else "reference"))
        reqs = [eng.submit(p, max_new_tokens=GEN) for p in _prompts()]
        eng.run()
        _JAX_WANT[key] = [list(r.out) for r in reqs]
    return _JAX_WANT[key]


def _fleet(cfg, params, n_shards, **ecfg):
    kw = dict(max_seqs=2, max_seq_len=64)
    kw.update(ecfg)
    return ShardedEngine(cfg, params, EngineConfig(**kw), n_shards=n_shards,
                         devices=["cpu"] * n_shards)


CASES = {
    # id: (model variant, shards, EngineConfig fields)
    "reference-2": ("plain", 2, {"attn_backend": "reference"}),
    "xla-4": ("plain", 4, {"attn_backend": "xla"}),
    "flash-2": ("plain", 2, {"attn_backend": "flash"}),
    "flash-4": ("plain", 4, {"attn_backend": "flash"}),
    "sharded-4": ("plain", 4, {}),                 # the default backend
    "kconv3-chunk7-2": ("kconv3", 2, {"attn_backend": "flash",
                                      "prefill_chunk": 7}),
    "kconv3-chunk24-4": ("kconv3", 4, {"attn_backend": "reference",
                                       "prefill_chunk": 24}),
    "int8-2": ("plain", 2, {"attn_backend": "xla", "kv_dtype": "int8"}),
    "preempt-recompute-2": ("plain", 2, {"attn_backend": "flash",
                                         "num_pages": 6, "swap_bytes": 0}),
    "preempt-swap-2": ("plain", 2, {"attn_backend": "xla",
                                    "num_pages": 6}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_streams_equal_jax_single_host(models, case):
    variant, n_shards, ecfg = CASES[case]
    cfg, params, _, _ = models[variant]
    want = _jax_streams(models, variant, ecfg.get("kv_dtype", "fp32"))
    sh = _fleet(cfg, params, n_shards, **ecfg)
    reqs = [sh.submit(p, max_new_tokens=GEN) for p in _prompts()]
    sh.run()
    assert [list(r.out) for r in reqs] == want
    assert sh.attn_backend == ecfg.get("attn_backend", "sharded")
    assert sum(s["requests"] for s in sh.shard_stats) == len(reqs)
    assert all(s["requests"] for s in sh.shard_stats[:len(reqs)])
    if "num_pages" in ecfg:
        assert sh.stats["preemptions"] > 0, "the case should preempt"
        if "swap_bytes" not in ecfg:
            assert sh.stats["swap_restores"] > 0
    if "prefill_chunk" in ecfg:
        assert sh.stats["prefill_tokens"] == sum(PROMPT_LENS)
    if variant == "kconv3":
        assert all(c["slot_1"]["key_conv_state"].shape[1] == 2
                   for c in sh.caches)


def test_staged_dispatch_ahead_equals_jax(models):
    """The staged API (``frontend.run_open_loop``) over 2 shards with
    decode dispatched ahead gives the same streams."""
    cfg, params, _, _ = models["plain"]
    want = _jax_streams(models, "plain", "fp32")
    sh = _fleet(cfg, params, 2, attn_backend="flash", dispatch_ahead=1)
    trace = [FE.TraceItem(prompt=p, max_new_tokens=GEN, arrival_step=2 * i)
             for i, p in enumerate(_prompts())]
    reqs = FE.run_open_loop(sh, trace)
    assert [list(r.out) for r in reqs] == want
    assert sh.stats["dispatch_depth_peak"] == 2


def test_adaptive_profile_shared_by_shards(models, tmp_path):
    """One routing profile (saved by the reference, every other head at
    budget 1) loaded once and shared by every shard: 2 and 4 shards give
    the JAX single-host engine's streams under it."""
    from repro.core import adaptive as JAD
    cfg, params, jcfg, jparams = models["plain"]
    prof = JAD.RoutingProfile.uniform(jcfg)
    for arr in prof.top_k.values():
        arr[:, ::2] = 1
    path = str(tmp_path / "profile.json")
    prof.save(path)
    policy = "profile:" + path
    one = JEngine(jcfg, jparams, JEngineConfig(max_seqs=4, max_seq_len=64,
                                               route_policy=policy,
                                               attn_backend="xla"))
    jreqs = [one.submit(p, max_new_tokens=GEN) for p in _prompts()]
    one.run()
    want = [list(r.out) for r in jreqs]
    assert want != _jax_streams(models, "plain", "fp32")   # budgets bite
    for n_shards in (2, 4):
        sh = _fleet(cfg, params, n_shards, route_policy=policy,
                    attn_backend="flash")
        reqs = [sh.submit(p, max_new_tokens=GEN) for p in _prompts()]
        sh.run()
        assert [list(r.out) for r in reqs] == want, n_shards
        assert not sh.route_profile.is_uniform


# --------------------------------------------------------- host pieces
def _router_picks(Sched, Req, Rt):
    """A fixed script of scheduler operations on three shards, the picks
    after each (queue demand, committed pages, a cached prefix)."""
    scheds = [Sched(num_pages=8, page_size=16, max_seqs=2,
                    max_pages_per_seq=4, prefix_cache=True)
              for _ in range(3)]
    router = Rt(scheds)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, 40, dtype=np.int32)

    def r(rid, n, prefix=False):
        p = rng.integers(0, 256, n, dtype=np.int32)
        if prefix:
            p = np.concatenate([shared, p])
        return Req(rid=rid, prompt=p, max_new_tokens=8)

    picks = [router.pick(r(0, 20))]
    scheds[0].submit(r(1, 20))                    # queued demand
    picks.append(router.pick(r(2, 20)))
    scheds[1].submit(r(3, 40))
    scheds[2].submit(r(4, 20))
    picks.append(router.pick(r(5, 20)))           # 0 and 2 tie → 0
    picks.append(router.pick(r(6, 100)))          # fits no shard → −1
    held = r(7, 9, prefix=True)                   # cache a prefix on 2
    scheds[2].submit(held)
    for req in scheds[2].plan_prefills(float("inf")):
        req.cache_len = len(req.context)
        scheds[2].note_cached(req)
    picks.append(router.pick(r(8, 5, prefix=True)))   # affinity beats load
    picks.append(router.pick(r(9, 5)))
    return picks, [s.load for s in scheds]


def test_router_pick_equals_jax():
    got = _router_picks(TSch.Scheduler, TSch.Request, Router)
    want = _router_picks(JSch.Scheduler, JSch.Request, JSh.Router)
    assert got == want
    assert got[0][:5] == [0, 1, 0, -1, 2]


def test_prefill_bucket_shard_invariant(models):
    """The bucket is a pure function of (longest take, page size), the
    reference's.  Each shard pads its rows to its own bucket (the
    reference's one global bucket is what its SPMD step needs): two
    shards prefilling ragged prompts in one step pad 40 tokens and 18 to
    their own buckets, and each request's stream equals the one it has
    alone on the single-device engine."""
    for ps in (16, 32, 128):
        for n in (1, 7, 16, 17, 40, 64, 100, 3000):
            assert prefill_bucket(n, ps) == j_prefill_bucket(n, ps)
    cfg, params, _, _ = models["plain"]
    sh = _fleet(cfg, params, 2, max_seqs=1)
    widths = [[], []]
    for s, eng in enumerate(sh.engines):
        def spy(params, tokens, *rest, _step=eng._prefill, _w=widths[s]):
            _w.append(tokens.shape[1])
            return _step(params, tokens, *rest)
        eng._prefill = spy
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (40, 18)]
    reqs = [sh.submit(p, 2) for p in prompts]
    assert [r.shard for r in reqs] == [0, 1]
    sh.step()
    assert widths == [[prefill_bucket(40, sh.page_size)],
                      [prefill_bucket(18, sh.page_size)]] != [[64], [64]]
    sh.run()
    for p, r in zip(prompts, reqs):
        one = Engine(cfg, params, EngineConfig(max_seqs=1, max_seq_len=64),
                     device="cpu")
        alone = one.submit(p, 2)
        one.run()
        assert r.out == alone.out


_INVARIANCE = {}


@hypothesis.settings(max_examples=3, deadline=None, derandomize=True,
                     database=None,
                     suppress_health_check=list(hypothesis.HealthCheck))
@hypothesis.given(stream=st.lists(st.tuples(st.integers(4, 40),
                                            st.integers(1, 8),
                                            st.floats(0, 1)),
                                  min_size=2, max_size=4),
                  data=st.data())
def test_property_streams_invariant_to_shards_and_order(stream, data):
    """Random request streams (lengths, budgets, arrivals) give the same
    per-request streams on one device and on 1, 2 and 4 shards, and
    under a permuted submission order (which changes the routing)."""
    if not _INVARIANCE:
        cfg = get_smoke_config("moba-340m")
        params = JT_free_params(cfg)
        _INVARIANCE["engines"] = (
            [Engine(cfg, params, EngineConfig(max_seqs=6, max_seq_len=64,
                                              attn_backend="flash"),
                    device="cpu")]
            + [_fleet(cfg, params, s, max_seqs=3, attn_backend="flash")
               for s in (1, 2, 4)])
        _INVARIANCE["reorder"] = _fleet(cfg, params, 2, max_seqs=3,
                                        attn_backend="flash")
    rng = np.random.default_rng(len(stream) * 1000 + stream[0][0])
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n, _, _ in stream]
    outs = []
    for eng in _INVARIANCE["engines"]:
        reqs = [eng.submit(p, max_new_tokens=g, arrival=t)
                for p, (_, g, t) in zip(prompts, stream)]
        eng.run()
        outs.append([list(r.out) for r in reqs])
    assert all(o == outs[0] for o in outs[1:]), outs
    perm = data.draw(st.permutations(range(len(stream))))
    eng = _INVARIANCE["reorder"]
    got = {i: eng.submit(prompts[i], max_new_tokens=stream[i][1],
                         arrival=stream[i][2]) for i in perm}
    eng.run()
    assert [list(got[i].out) for i in range(len(stream))] == outs[0]


def JT_free_params(cfg):
    """Seeded port weights (no JAX involved)."""
    from repro_torch.models import transformer as T
    return T.init_lm(torch.Generator().manual_seed(0), cfg)


# ------------------------------------------------------------ entry points
def test_shards_reach_the_entry_points():
    """``serve`` returns the single-device engine's tokens through 2
    shards; ``serve_stream`` and ``serve_openloop`` report per-shard
    tokens/s and requests; the CLI prints one line a shard."""
    kw = dict(batch=3, prompt_len=33, gen=6, attn_backend="xla",
              device="cpu")
    np.testing.assert_array_equal(TS.serve("moba-340m", shards=2, **kw),
                                  TS.serve("moba-340m", **kw))
    common = dict(n_requests=6, max_seqs=2, device="cpu", shards=2,
                  attn_backend="flash")
    for m in (TS.serve_stream("moba-340m", realtime=False, **common),
              TS.serve_openloop("moba-340m", every=2, **common)):
        assert m["requests"] == 6
        assert len(m["per_shard_tokens_per_s"]) == 2
        assert sum(m["per_shard_requests"]) == 6
        assert all(x > 0 for x in m["per_shard_tokens_per_s"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        TS.main(["--smoke", "--device", "cpu", "--shards", "2",
                 "--requests", "4", "--rate", "1000"])
    text = out.getvalue()
    assert "stream: 4 requests" in text
    assert "shard 0:" in text and "shard 1:" in text


def test_devices_default_to_one_card_a_shard(models):
    """``devices=None`` puts shard i on ``cuda:i``: more shards than
    visible cards raise the reference's error, never share a device."""
    cfg, params, _, _ = models["plain"]
    n = torch.cuda.device_count() + 1
    with pytest.raises(ServingError, match="exceeds the"):
        ShardedEngine(cfg, params, EngineConfig(), n_shards=n)
    with pytest.raises(UnsupportedFeatureError) as ei:
        _fleet(cfg, params, 2, attn_backend="sp")
    assert ei.value.feature == "attn_backend" and "sharded" in str(ei.value)
    sh = _fleet(cfg, params, 3)
    assert len(sh.caches) == len(sh.engines) == 3
    assert all(e.params is sh.params for e in sh.engines)   # one copy a device
    with pytest.raises(ServingError, match="context-parallel capacity"):
        sh.submit(np.zeros(3 * sh.shard_capacity, np.int32), 4)


# ------------------------------------------------------------ capabilities
def test_capabilities_equal_jax(tmp_path):
    for name in ("sp", "sp_unrolled", "sharded"):
        assert dataclasses.asdict(B.get(name).capabilities) \
            == dataclasses.asdict(JB.get(name).capabilities), name
    for name in B.names():
        assert B.get(name).capabilities.sharded \
            == JB.get(name).capabilities.sharded, name
    assert B.get("sharded").inner == JB.get("sharded").inner == "xla"
    with pytest.raises(B.BackendCapabilityError, match="sharded"):
        B.resolve("sp", kind="moba", phase="prefill", sharded=True)
    with pytest.raises(B.BackendCapabilityError):
        B.resolve("sp", kind="moba", phase="decode", cache="paged")
    header = B.capability_matrix().splitlines()[0]
    assert "sharded" in header and "adaptive" in header
    doc = tmp_path / "backends.md"
    doc.write_text("# Backends\n\n<!-- capability-matrix:begin (generated) "
                   "-->\nstale\n<!-- capability-matrix:end -->\ntail\n")
    assert B.sync_docs(str(doc)) is True
    text = doc.read_text()
    assert "stale" not in text and B.capability_matrix() in text
    assert text.endswith("<!-- capability-matrix:end -->\ntail\n")
    assert B.sync_docs(str(doc)) is False
