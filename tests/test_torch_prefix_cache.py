"""The port's radix-tree prefix cache against the JAX engine and against
its own prefix-cache-off engine (the cases of tests/test_prefix_cache.py).

With ``prefix_cache=True`` greedy tokens are exactly the JAX engine's and
the port's no-cache tokens, while requests sharing a prompt prefix map
the same physical pages: at page-aligned (96 = 6 x 16) and misaligned
(101: a copy-on-write of the shared tail page) share points, from fp32
and int8 pools (quantized pools share whole pages only), under chunked
prefill, on the ``flash`` backend (the decode kernel's plain version on
CPU tensors), for kconv3 (the ring loaded from the last matched page's
raw-key tail), across a multi-turn follow-up, and through swap, recompute
and tree eviction.  The device-side ops (``copy_pages``,
``load_ring_from_tails``, ``update_key_conv_tails``) equal JAX's on the
same numpy pools.
"""
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serving import paged_cache as JPC
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import ServingError
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _models(**ckw):
    jcfg = jax_smoke_config("moba-340m", **ckw)
    cfg = get_smoke_config("moba-340m", **ckw)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def model():
    return _models()


@pytest.fixture(scope="module")
def kconv():
    return _models(key_conv_width=3)


def _prompts(n=6, prefix_len=96, seed=3, vocab=256):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, 5 + i,
                                                 dtype=np.int32)])
            for i in range(n)]


def _serve(cfg, params, prompts, gen=8, jax_engine=False, **ekw):
    ekw.setdefault("max_seqs", 2)       # staggered admission: later
    ekw.setdefault("max_seq_len", 160)  # requests see cached prefixes
    ekw.setdefault("attn_backend", "reference")
    if jax_engine:
        eng = JEngine(cfg, params, JEngineConfig(**ekw))
    else:
        eng = Engine(cfg, params, EngineConfig(**ekw), device="cpu")
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    return [list(r.out) for r in reqs], eng


PREFIX_KEYS = ("prefix_hits", "prefix_hit_tokens", "prefix_prompt_tokens",
               "cow_copies", "tree_evictions")


def _three_ways(m, prompts, **ekw):
    """(port on, port off, JAX on) tokens and the two on engines."""
    jcfg, jparams, cfg, params = m
    on, eng = _serve(cfg, params, prompts, prefix_cache=True, **ekw)
    off, _ = _serve(cfg, params, prompts, **ekw)
    want, jeng = _serve(jcfg, jparams, prompts, prefix_cache=True,
                        jax_engine=True, **ekw)
    assert on == off == want
    assert {k: eng.stats[k] for k in PREFIX_KEYS} == \
        {k: jeng.stats[k] for k in PREFIX_KEYS}
    return eng


# ------------------------------------------------- engine token exactness
@pytest.mark.parametrize("prefix_len", [96, 101])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefix_cache_tokens_equal_jax(model, prefix_len, kv_dtype):
    kw = ({} if kv_dtype == "fp32"
          else {"attn_backend": "xla", "kv_dtype": kv_dtype})
    eng = _three_ways(model, _prompts(prefix_len=prefix_len), **kw)
    st = eng.stats
    assert st["prefix_hits"] == 4       # all but the first admission wave
    assert st["prefix_hit_tokens"] >= 4 * (prefix_len // 16) * 16
    if kv_dtype != "fp32":              # whole pages only
        assert st["prefix_hit_tokens"] % 16 == 0
    misaligned = prefix_len % 16 != 0
    assert st["cow_copies"] == (
        4 if misaligned and kv_dtype == "fp32" else 0)


def test_prefix_cache_pages_physically_shared(model):
    """A hit maps the same physical page ids as the request that filled
    the tree: sharing, not copying."""
    _, _, cfg, params = model
    prompts = _prompts(prefix_len=64)
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=4, max_seq_len=160, prefix_cache=True), device="cpu")
    eng.submit(prompts[0], max_new_tokens=4)
    eng.run()
    b = eng.submit(prompts[1], max_new_tokens=4)
    eng.step()
    shared = eng.sched._seq_pages[b.slot][:4]
    assert b.prefix_len == 64
    assert all(eng.sched.alloc.refcount(p) == 2 for p in shared)
    got, n = eng.sched.tree.match(prompts[0][:64], touch=False)
    assert got == shared and n == 64
    eng.run()
    assert b.done


def test_prefix_cache_multi_turn_reuse(model):
    """Turn 2 = turn 1's prompt, its output and 3 new tokens: the finished
    request's cache (partial tail included) serves it; its tokens equal a
    fresh engine's and the JAX engine's."""
    jcfg, jparams, cfg, params = model
    prompt = _prompts(prefix_len=64)[0]
    turns = []
    for jax_engine, (c, p) in ((False, (cfg, params)),
                               (True, (jcfg, jparams))):
        kw = {} if jax_engine else {"device": "cpu"}
        eng = (JEngine if jax_engine else Engine)(c, p, (
            JEngineConfig if jax_engine else EngineConfig)(
            max_seqs=2, max_seq_len=160, prefix_cache=True), **kw)
        a = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        turn2 = np.concatenate([prompt, np.asarray(a.out, np.int32),
                                np.asarray([1, 2, 3], np.int32)])
        b = eng.submit(turn2, max_new_tokens=4)
        eng.run()
        assert eng.stats["prefix_hit_tokens"] >= (len(turn2) // 16 - 1) * 16
        turns.append((list(a.out), list(b.out)))
    assert turns[0] == turns[1]
    fresh, _ = _serve(cfg, params, [turn2], gen=4)
    assert turns[0][1] == fresh[0]


def test_prefix_cache_chunked_prefill_equal_jax(model):
    eng = _three_ways(model, _prompts(), prefill_chunk=32)
    assert eng.stats["prefix_hits"] > 0


def test_prefix_cache_flash_backend_equal_jax(model):
    eng = _three_ways(model, _prompts(n=4), attn_backend="flash")
    assert eng.stats["prefix_hits"] > 0


def test_prefix_cache_key_conv_ring_from_tails(kconv):
    """kconv3 shares full pages only; the suffix prefill's ring comes from
    the boundary page's raw-key tail, so tokens stay exact."""
    eng = _three_ways(kconv, _prompts())
    st = eng.stats
    assert st["prefix_hits"] > 0 and st["cow_copies"] == 0
    assert st["prefix_hit_tokens"] % eng.page_size == 0
    assert "key_conv_tails" in eng.caches["slot_1"]


def _staged_suffix(cfg, params, prompts, prefix_cache):
    """Prefill ``prompts[-1]`` (after serving the others with the cache
    on); return its convolved keys in the kconv slot's pages, its ring
    row and the engine."""
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=2, max_seq_len=160, prefix_cache=prefix_cache),
        device="cpu")
    if prefix_cache:
        for p in prompts[:-1]:
            eng.submit(p, max_new_tokens=4)
        eng.run()
    req = eng.make_request(prompts[-1], 4)
    assert eng.prefill(req) is not None
    pool = eng.caches["slot_1"]
    g, _, ps, hkv, d = pool["pages_k"].shape
    pages = eng.sched._seq_pages[req.slot]
    keys = pool["pages_k"][:, pages].reshape(g, -1, hkv, d)
    return (keys[:, :len(prompts[-1])].clone(),
            pool["key_conv_state"][:, req.slot].clone(), eng)


def test_prefix_cache_key_conv_suffix_keys_equal_one_shot(kconv):
    """After a prefix hit, the suffix prefill convolves from the ring its
    tail load gave it: its keys and its ring row equal a one-shot prefill
    of the whole prompt (the first W-1 suffix keys would differ from a
    zero or stale ring)."""
    _, _, cfg, params = kconv
    prompts = _prompts(n=2, prefix_len=101)
    k_on, ring_on, eng = _staged_suffix(cfg, params, prompts, True)
    k_off, ring_off, _ = _staged_suffix(cfg, params, prompts, False)
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["prefix_hit_tokens"] == 96     # whole pages only
    torch.testing.assert_close(k_on, k_off, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ring_on, ring_off, rtol=1e-6, atol=1e-6)


def test_prefix_cache_key_conv_chunked_flash(kconv):
    """kconv3 with chunk edges inside pages, on flash."""
    jcfg, jparams, cfg, params = kconv
    on, eng = _serve(cfg, params, _prompts(n=4), prefix_cache=True,
                     prefill_chunk=24, attn_backend="flash")
    off, _ = _serve(cfg, params, _prompts(n=4), prefill_chunk=24,
                    attn_backend="flash")
    assert on == off and eng.stats["prefix_hits"] > 0


def test_prefix_cache_key_conv_width_guard():
    """The ring spans width-1 raw keys; loading it from one page's tail
    needs width-1 <= page_size, else construction refuses."""
    cfg = get_smoke_config("moba-340m", key_conv_width=18)
    from repro_torch.models import transformer as T
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ServingError, match="key_conv"):
        Engine(cfg, params, EngineConfig(max_seqs=2, max_seq_len=160,
                                         prefix_cache=True), device="cpu")


@pytest.mark.parametrize("arch", ["plain", "kconv3"])
def test_prefix_cache_swap_replay_equal_jax(model, kconv, arch):
    """An undersized pool preempts by swap; pages (the key-conv tails
    among them) and rings round-trip through the host store.  Tokens
    equal a fully provisioned engine's and the JAX engine's."""
    m = model if arch == "plain" else kconv
    jcfg, jparams, cfg, params = m
    prompts = _prompts()
    oracle, _ = _serve(cfg, params, prompts, gen=12, max_seqs=4)
    on, eng = _serve(cfg, params, prompts, gen=12, max_seqs=4,
                     num_pages=24, prefix_cache=True)
    want, jeng = _serve(jcfg, jparams, prompts, gen=12, max_seqs=4,
                        num_pages=24, prefix_cache=True, jax_engine=True)
    assert on == oracle == want
    assert eng.stats["swap_saves"] > 0
    assert eng.stats["swap_restores"] == eng.stats["swap_saves"] == \
        jeng.stats["swap_saves"]


def test_swap_budget_capped_falls_back_to_recompute(model):
    """A swap budget too small for one victim: the victim's cache is
    published to the tree and its replay recomputes, prefix-accelerated."""
    _, _, cfg, params = model
    prompts = _prompts()
    off, _ = _serve(cfg, params, prompts, gen=12, max_seqs=4,
                    num_pages=24, swap_bytes=0)
    on, eng = _serve(cfg, params, prompts, gen=12, max_seqs=4,
                     num_pages=24, prefix_cache=True, swap_bytes=1)
    assert on == off
    assert eng.stats["swap_fallbacks"] > 0
    assert eng.stats["swap_restores"] == 0


def test_tree_eviction_under_pool_pressure(model):
    """Cold prefixes are evicted to admit new work; tokens stay exact."""
    _, _, cfg, params = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, 80 + i, dtype=np.int32)
               for i in range(6)]
    off, _ = _serve(cfg, params, prompts, gen=6, max_seqs=2, num_pages=16)
    on, eng = _serve(cfg, params, prompts, gen=6, max_seqs=2,
                     num_pages=16, prefix_cache=True)
    assert on == off
    assert eng.stats["tree_evictions"] > 0


def test_staged_dispatch_ahead_equals_run(model):
    """The staged API with decode dispatched ahead publishes pages at
    observed boundaries only; its streams equal ``run()``'s."""
    _, _, cfg, params = model
    prompts = _prompts(n=4)
    want, _ = _serve(cfg, params, prompts, prefix_cache=True)
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=2, max_seq_len=160, prefix_cache=True, dispatch_ahead=2),
        device="cpu")
    reqs = [eng.make_request(p, 8) for p in prompts]
    pending = list(reqs)
    while pending or eng.has_work():
        while pending:
            pre = eng.prefill(pending[0])
            if pre is None:
                break
            assert eng.insert(pre)
            pending.pop(0)
        eng.generate_step()
    assert [list(r.out) for r in reqs] == want
    assert eng.stats["prefix_hits"] > 0


# ------------------------------------------------- device ops against JAX
def _pools(seed, kv_dtype="fp32", g=2, p=6, ps=8, hkv=2, d=4, depth=2,
           slots=3):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    pool = {"pages_k": rnd(g, p, ps, hkv, d), "pages_v": rnd(g, p, ps, hkv, d),
            "centroids": rnd(g, p, hkv, d),
            "key_conv_state": rnd(g, slots, hkv, depth, d),
            "key_conv_tails": rnd(g, p, hkv, depth, d)}
    if kv_dtype == "int8":
        pool["pages_k"] = rng.integers(-127, 128, (g, p, ps, hkv, d),
                                       dtype=np.int8)
        pool["scales_k"] = rnd(g, p, hkv)
    return {"slot_0": {k: v for k, v in pool.items()
                       if not k.startswith("key_conv")},
            "slot_1": pool}


def _both(np_caches):
    return (jax.tree.map(jnp.asarray, np_caches),
            jax.tree.map(torch.from_numpy, jax.tree.map(np.copy, np_caches)))


def _assert_caches_equal(got, want):
    assert {s: set(p) for s, p in got.items()} == \
        {s: set(p) for s, p in want.items()}
    for s, pool in want.items():
        for leaf, x in pool.items():
            np.testing.assert_array_equal(got[s][leaf].numpy(),
                                          np.asarray(x), err_msg=(s, leaf))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_copy_pages_equals_jax(kv_dtype):
    jc, tc = _both(_pools(1, kv_dtype))
    for s, d in ((4, 1), (0, 5)):
        jc = JPC.copy_pages(jc, [s], [d])
        tc = PC.copy_pages(tc, [s], [d])
    _assert_caches_equal(tc, jc)


def test_load_ring_from_tails_equals_jax():
    jc, tc = _both(_pools(2))
    jc = JPC.load_ring_from_tails(jc, [2, 0], [5, 3])
    tc = PC.load_ring_from_tails(tc, [2, 0], [5, 3])
    _assert_caches_equal(tc, jc)


TAIL_CASES = {
    # ragged prefill: rows across page ends, a padding row, a -1 page
    "prefill": dict(kv_len=[0, 5, 13, 0], q_len=[11, 14, 2, 0], length=14),
    # decode: one token a row, the active mask as q_len
    "decode": dict(kv_len=[6, 7, 15, 3], q_len=[1, 1, 0, 1], length=1),
    # nothing lands in a tail: every tail, page 0's included, untouched
    "none": dict(kv_len=[0, 8, 0, 1], q_len=[3, 2, 0, 1], length=3),
}


@pytest.mark.parametrize("case", TAIL_CASES)
def test_update_key_conv_tails_equals_jax(case):
    c = TAIL_CASES[case]
    rng = np.random.default_rng(3)
    ps, depth, hkv, d, num_pages, npg = 8, 2, 2, 4, 9, 3
    pool = {"pages_k": np.zeros((num_pages, ps, hkv, d), np.float32),
            "key_conv_tails": rng.standard_normal(
                (num_pages, hkv, depth, d)).astype(np.float32)}
    table = np.array([[3, 1, 7], [2, 8, -1], [5, 6, 4], [0, -1, -1]],
                     np.int32)
    k_raw = rng.standard_normal((4, hkv, c["length"], d)).astype(np.float32)
    args = [table, np.array(c["kv_len"], np.int32),
            np.array(c["q_len"], np.int32), k_raw]
    want = JPC.update_key_conv_tails(
        jax.tree.map(jnp.asarray, pool), *map(jnp.asarray, args))
    got = PC.update_key_conv_tails(
        jax.tree.map(torch.from_numpy, jax.tree.map(np.copy, pool)),
        *map(torch.from_numpy, args))
    np.testing.assert_array_equal(got["key_conv_tails"].numpy(),
                                  np.asarray(want["key_conv_tails"]))
    if case == "none":
        np.testing.assert_array_equal(got["key_conv_tails"].numpy(),
                                      pool["key_conv_tails"])


def test_swap_snapshot_carries_tails(kconv):
    """``gather_pages_host`` / ``scatter_pages_device`` move the tails
    with the pages, bit for bit."""
    _, _, cfg, params = kconv
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_seq_len=160,
                                           prefix_cache=True), device="cpu")
    tails = eng.caches["slot_1"]["key_conv_tails"]
    tails.copy_(torch.randn(tails.shape))
    snap = PC.gather_pages_host(eng.caches, [1, 4])
    assert ("slot_1", "key_conv_tails") in snap
    PC.scatter_pages_device(eng.caches, [6, 2], snap)
    torch.testing.assert_close(tails[:, [6, 2]], tails[:, [1, 4]],
                               rtol=0, atol=0)


def test_serve_cli_prefix_cache_on_cpu():
    """``--prefix-cache`` with chunked prefill and swap off: exits 0 and
    reports the cache's hit rate and COW copies."""
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--mode", "batch", "--device", "cpu", "--attn-backend", "flash",
         "--batch", "2", "--gen", "4", "--prefix-cache",
         "--prefill-chunk", "32", "--swap-bytes", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "prefix cache: hit rate" in res.stdout
    assert "COW copies" in res.stdout
