"""Model pieces and the whole smoke model of the PyTorch port against the
JAX reference, on the same numpy-made inputs and converted weights.

Primitives at fp32 round-off; the smoke moba-340m's paged prefill and
decode logits at the 2e-4 fp32 tolerance of ``tests/test_kernels.py``;
block selections bit-equal; the page pools (K/V payload and centroid
cache) equal after the appends.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import attention as JA
from repro.core import moba as JM
from repro.core import routing as JR
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import paged_cache as JPC
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoBAConfig
from repro_torch.convert import from_jax
from repro_torch.core import attention as TA
from repro_torch.core import moba as TM
from repro_torch.core import routing as TR
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import paged_cache as TPC
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=2e-4, rtol=2e-4)         # tests/test_kernels.py:24 (fp32)
# jitted once per test module: op-by-op JAX would compile every primitive
J_APPEND_PREFILL = jax.jit(JPC.paged_append_prefill)
J_APPEND_DECODE = jax.jit(JPC.paged_append_decode)
EXACT = dict(atol=1e-6, rtol=1e-6)       # same fp32 ops, other libraries


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# -------------------------------------------------------------- primitives
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 32), _rand(rng, 32)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(scale)).numpy(),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **EXACT)


@pytest.mark.parametrize("per_row", [False, True], ids=["1d", "per-row"])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, 4, 6, 16)
    pos = (rng.integers(0, 500, (3, 6)) if per_row
           else np.arange(6) + 17).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), _t(pos)).numpy(),
        _np(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos))), **TOL)


DENSE_CASES = {
    "causal": dict(),
    "window": dict(window=7),
    "kv_len": dict(kv_len=np.array([20, 9], np.int32)),
    "per-row-positions": dict(
        q_positions=np.array([[14, 15, 16, 17], [3, 4, 5, 6]], np.int32),
        kv_len=np.array([18, 7], np.int32), window=5),
}


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_attention_matches_jax(case):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 4, 4, 16), _rand(rng, 2, 2, 24, 16), \
        _rand(rng, 2, 2, 24, 16)
    kw = DENSE_CASES[case]
    got = TA.dense_attention(_t(q), _t(k), _t(v), **{
        n: (_t(a) if isinstance(a, np.ndarray) else a)
        for n, a in kw.items()})
    want = JA.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **{n: (jnp.asarray(a) if isinstance(
                                  a, np.ndarray) else a)
                                 for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("kv_len", [None, 45], ids=["full", "kv_len"])
def test_block_centroids_matches_jax(kv_len):
    rng = np.random.default_rng(3)
    k = _rand(rng, 2, 3, 70, 8)                      # ragged tail block
    np.testing.assert_allclose(
        TR.block_centroids(_t(k), 16, kv_len=kv_len).numpy(),
        _np(JR.block_centroids(jnp.asarray(k), 16, kv_len=kv_len)), **EXACT)


def test_routing_scores_match_jax():
    rng = np.random.default_rng(3)
    q, c = _rand(rng, 2, 3, 5, 8), _rand(rng, 2, 3, 4, 8)
    np.testing.assert_allclose(
        TR.routing_scores(_t(q), _t(c)).numpy(),
        _np(JR.routing_scores(jnp.asarray(q), jnp.asarray(c))), **EXACT)


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_moba_selection_bit_equal(tied):
    rng = np.random.default_rng(4)
    q, k = _rand(rng, 2, 4, 50, 16), _rand(rng, 2, 2, 50, 16)
    if tied:
        k[:] = k[:, :, :1]                    # every block scores the same
    cfg_j, cfg_t = JMoBAConfig(16, 3), MoBAConfig(16, 3)
    np.testing.assert_array_equal(
        TM.moba_selection(_t(q), _t(k), cfg_t).numpy(),
        _np(JM.moba_selection(jnp.asarray(q), jnp.asarray(k), cfg_j)))


def test_moba_attention_reference_matches_jax():
    """GQA, a ragged tail block, per-row kv_len masks."""
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 2, 4, 50, 16), _rand(rng, 2, 2, 50, 16), \
        _rand(rng, 2, 2, 50, 16)
    kv = np.array([50, 31], np.int32).reshape(2, 1, 1, 1)
    got = TM.moba_attention_reference(_t(q), _t(k), _t(v), MoBAConfig(16, 2),
                                      kv_len=_t(kv))
    want = JM.moba_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JMoBAConfig(16, 2),
        kv_len=jnp.asarray(kv))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ----------------------------------------------------------- paged pools
def _pool_pair(rng, num_pages=24, ps=16, hkv=2, d=16):
    shape = (num_pages, ps, hkv, d)
    pool = {"pages_k": _rand(rng, *shape), "pages_v": _rand(rng, *shape),
            "centroids": np.zeros((num_pages, hkv, d), np.float32)}
    return ({k: jnp.asarray(v) for k, v in pool.items()},
            {k: _t(v) for k, v in pool.items()})


def _assert_pools_equal(tpool, jpool):
    for name in ("pages_k", "pages_v"):
        np.testing.assert_array_equal(tpool[name].numpy(), _np(jpool[name]))
    np.testing.assert_allclose(tpool["centroids"].numpy(),
                               _np(jpool["centroids"]), **EXACT)


def test_paged_appends_and_centroids_match_jax():
    """Prefill (fresh and chunk continuation) then decode appends, with
    padding rows and inactive slots: the same pool bytes and centroid
    cache as the reference."""
    rng = np.random.default_rng(6)
    jpool, tpool = _pool_pair(rng)
    table = np.array([[3, 7, 1, 4], [9, 0, 5, -1], [-1, -1, -1, -1]],
                     np.int32)
    b, hkv, d = 3, 2, 16
    steps = [  # (kv_len, q_len, L)
        (np.array([0, 0, 0]), np.array([21, 9, 0]), 24),
        (np.array([21, 9, 0]), np.array([16, 8, 0]), 16),
    ]
    for kv_len, q_len, length in steps:
        k, v = _rand(rng, b, hkv, length, d), _rand(rng, b, hkv, length, d)
        args = (table, q_len.astype(np.int32), k, v)
        jpool = J_APPEND_PREFILL(
            jpool, *map(jnp.asarray, args), kv_len=jnp.asarray(
                kv_len.astype(np.int32)))
        TPC.paged_append_prefill(tpool, *map(_t, args),
                                 kv_len=_t(kv_len.astype(np.int32)))
        _assert_pools_equal(tpool, jpool)
    lens = np.array([37, 17, 0], np.int32)
    active = np.array([True, True, False])
    for _ in range(12):                         # crosses a page boundary
        k, v = _rand(rng, b, hkv, 1, d), _rand(rng, b, hkv, 1, d)
        args = (table, lens, active, k, v)
        jpool = J_APPEND_DECODE(jpool, *map(jnp.asarray, args))
        TPC.paged_append_decode(tpool, *map(_t, args))
        lens = lens + active
    _assert_pools_equal(tpool, jpool)
    # the incremental centroids still equal a recompute from stored keys
    kf, _ = TPC.paged_gather_kv(tpool, _t(table))
    for i, n in enumerate(lens[:2]):
        want = TR.block_centroids(kf[i][:, :n], 16)
        got = tpool["centroids"][_t(table[i, :-(-n // 16)]).long()]
        torch.testing.assert_close(got.permute(1, 0, 2), want, atol=1e-5,
                                   rtol=1e-5)


def test_swa_and_chunk_prefill_attention_match_jax():
    rng = np.random.default_rng(7)
    jpool, tpool = _pool_pair(rng)
    table = np.array([[3, 7, 1, 4], [9, 0, 2, -1]], np.int32)
    kv_len, q_len = np.array([30, 11], np.int32), np.array([12, 5], np.int32)
    k, v = _rand(rng, 2, 2, 12, 16), _rand(rng, 2, 2, 12, 16)
    args = (table, q_len, k, v)
    jpool = J_APPEND_PREFILL(jpool, *map(jnp.asarray, args),
                             kv_len=jnp.asarray(kv_len))
    TPC.paged_append_prefill(tpool, *map(_t, args), kv_len=_t(kv_len))
    q = _rand(rng, 2, 4, 12, 16)
    got = TM.moba_paged_prefill_attention(
        _t(q), tpool["pages_k"], tpool["pages_v"], tpool["centroids"],
        _t(table), _t(kv_len), _t(q_len), MoBAConfig(16, 2))
    want = jax.jit(JM.moba_paged_prefill_attention, static_argnums=7)(
        jnp.asarray(q), jpool["pages_k"], jpool["pages_v"],
        jpool["centroids"], jnp.asarray(table), jnp.asarray(kv_len),
        jnp.asarray(q_len), JMoBAConfig(16, 2))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    qd = _rand(rng, 2, 4, 1, 16)
    post = kv_len + q_len
    for window in (7, 16, 33):
        got = TPC.swa_windowed_decode_attention(_t(qd), tpool, _t(table),
                                                _t(post), window)
        want = jax.jit(JPC.swa_windowed_decode_attention,
                       static_argnums=4)(
            jnp.asarray(qd), jpool, jnp.asarray(table), jnp.asarray(post),
            window)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ------------------------------------------------------------ whole model
@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("moba-340m")
    tcfg = get_smoke_config("moba-340m")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_lm_apply_matches_jax(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    tokens = np.random.default_rng(8).integers(0, 256, (2, 40)).astype(
        np.int32)
    want, _, _ = JT.lm_apply(jparams, jnp.asarray(tokens), jcfg)
    got, _, _ = TT.lm_apply(tparams, _t(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("chunked", [False, True], ids=["one-shot",
                                                         "chunk-aware"])
def test_paged_prefill_then_decode_logits_match_jax(smoke, chunked):
    """Ragged paged prefill, then three decode steps, through the whole
    smoke model: logits at the fp32 tolerance, pools equal."""
    jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(9)
    ps, npg, num_pages = 16, 4, 12
    q_len = np.array([40, 23, 0], np.int32)            # one padding row
    table = np.array([[5, 2, 9, 11], [0, 7, -1, -1], [-1] * 4], np.int32)
    tokens = np.zeros((3, 48), np.int32)
    for i, n in enumerate(q_len):
        tokens[i, :n] = rng.integers(0, 256, n)
    jc = JT.init_paged_caches(jcfg, num_pages, ps, dtype=jnp.float32)
    tc = TT.init_paged_caches(tcfg, num_pages, ps, dtype=torch.float32,
                              device="cpu")
    zeros = np.zeros(3, np.int32)
    active = q_len > 0

    def state(kv, ql, act, lib, extra):
        conv = jnp.asarray if lib == "jax" else _t
        st = {"block_table": conv(table), "kv_len": conv(kv),
              "q_len": conv(ql), "active": conv(act)}
        st.update(extra)
        return st

    extra = {"chunked": chunked, "slots": None}
    pos = np.arange(48)
    jl, jc = JT.prefill(jparams, jnp.asarray(tokens), jcfg, jc,
                        page_state=state(zeros, q_len, active, "jax", extra),
                        positions=jnp.asarray(pos) if not chunked
                        else jnp.asarray(zeros[:, None] + pos))
    tl, tc = TT.prefill(tparams, _t(tokens), tcfg, tc,
                        page_state=state(zeros, q_len, active, "torch",
                                         extra),
                        positions=_t(pos) if not chunked
                        else _t(zeros[:, None] + pos))
    act = q_len > 0
    np.testing.assert_allclose(tl.numpy()[act], _np(jl)[act], **TOL)
    lens = q_len.copy()
    tok = np.array([7, 200, 0], np.int32)
    for _ in range(3):
        ql = active.astype(np.int32)
        jl, jc = JT.decode_step(jparams, jnp.asarray(tok[:, None]), jcfg, jc,
                                page_state=state(lens, ql, active, "jax", {}))
        tl, tc = TT.decode_step(tparams, _t(tok[:, None]), tcfg, tc,
                                page_state=state(lens, ql, active, "torch",
                                                 {}))
        np.testing.assert_allclose(tl.numpy()[act], _np(jl)[act], **TOL)
        tok = np.argmax(_np(jl)[:, -1], -1).astype(np.int32)
        lens = lens + active
    for slot, pool in tc.items():
        for name, leaf in pool.items():
            np.testing.assert_allclose(leaf.numpy(), _np(jc[slot][name]),
                                       **TOL)


def test_from_jax_checks_the_tree(smoke):
    jcfg, tcfg, jparams, _ = smoke
    params = jax.tree.map(np.asarray, jparams)
    params["final_norm"] = params["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        from_jax(params, tcfg, device="cpu")
    params = jax.tree.map(np.asarray, jparams)
    del params["lm_head"]
    with pytest.raises(ValueError, match="expected keys"):
        from_jax(params, tcfg, device="cpu")
