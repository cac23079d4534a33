"""The fixed serving loop in the PyTorch port against the JAX package:
dense per-sequence caches, the dense-cache MoBA decode, the step
builders and ``serve_fixed``, on the same numpy-made inputs and converted
weights.

* ``core/moba.py::moba_decode_attention`` against the reference's (fp32,
  2e-4) with its selections bit-identical to ``lax.top_k`` on the
  reference's masked scores: a ragged cache tail, ``kv_len`` 1 and at a
  block edge, with and without the centroid cache, fewer blocks than
  ``top_k``, and ties at 0.0 cut by ``top_k``;
* the public ``moba_attention`` against the reference's under each
  backend, with and without key-conv weights (fp32, 2e-4);
* ``init_caches`` leaves, and a prefill plus 4 decode steps through
  ``apply_attention`` on a dense cache (k, v, centroids, key-conv state,
  outputs; fp32 2e-4);
* ``serve_fixed`` tokens on moba-340m and qwen3-0.6b under ``reference``,
  ``xla`` and ``flash`` (on CPU tensors ``flash`` runs its kernels' plain
  versions) equal to JAX's ``serve_fixed(attn_backend="reference")`` and
  to the port's paged engine, and the engine's options refused by the
  fixed loop; the kconv3 model through
  ``make_prefill_step``/``make_decode_step`` on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import moba as JM
from repro.core import routing as JR
from repro.launch import serve as JS
from repro.launch import steps as JSt
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoBAConfig
from repro_torch.convert import from_jax
from repro_torch.core import moba as TM
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as TSt
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import UnsupportedFeatureError
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=2e-4, rtol=2e-4)         # tests/test_kernels.py:24 (fp32)
BACKENDS = ("reference", "xla", "flash")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_params(jparams):
    return jax.tree.map(np.asarray, jparams)


# ------------------------------------------------ dense-cache MoBA decode
def _jax_selection(q, k, kv_len, cfg, cents):
    """``lax.top_k`` over the reference's masked decode scores
    (``src/repro/core/moba.py::moba_decode_attention``'s routing lines):
    (idx with invalid slots 0, sel_valid, masked scores)."""
    b, h, _, d = q.shape
    hkv, nmax = k.shape[1], k.shape[2]
    bs = cfg.block_size
    nb = -(-nmax // bs)
    k = JR.pad_to_blocks(k, bs, axis=-2)
    if cents is None:
        cents = JR.block_centroids(k, bs, kv_len=kv_len)
    qg = q.reshape(b, hkv, h // hkv, 1, d).astype(jnp.float32)
    scores = jnp.einsum("bhgqd,bhnd->bhgqn", qg, cents.astype(jnp.float32))
    blk = jnp.arange(nb)
    masked = jnp.where(blk * bs < kv_len, scores, JR.NEG_INF)
    masked = jnp.where(blk == max(kv_len - 1, 0) // bs, JR.POS_INF, masked)
    kk = min(cfg.top_k, nb)
    top_s, top_idx = jax.lax.top_k(masked, kk)
    top_s = jnp.concatenate(
        [top_s, jnp.full(top_s.shape[:-1] + (cfg.top_k - kk,), JR.NEG_INF)],
        -1)
    top_idx = jnp.concatenate(
        [top_idx, jnp.zeros(top_idx.shape[:-1] + (cfg.top_k - kk,),
                            top_idx.dtype)], -1)
    valid = top_s > JR.NEG_INF / 2
    return (np.asarray(jnp.where(valid, top_idx, 0)), np.asarray(valid),
            np.asarray(masked))


DECODE_CASES = {
    # id: (nmax, kv_len, block, top_k, centroid cache, ties)
    "ragged-tail": (100, 77, 16, 3, False, False),
    "ragged-tail-cents": (100, 77, 16, 3, True, False),
    "kv-len-1": (64, 1, 16, 3, False, False),
    "kv-len-1-cents": (64, 1, 16, 3, True, False),
    "block-edge": (96, 32, 16, 2, False, False),
    "block-edge-plus-1-cents": (96, 33, 16, 2, True, False),
    "few-blocks": (40, 40, 16, 5, False, False),
    "few-blocks-cents": (40, 29, 16, 5, True, False),
    "zero-ties-cents": (160, 160, 16, 4, True, True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_moba_decode_attention_equals_jax(case):
    nmax, kv_len, bs, top_k, with_cents, ties = DECODE_CASES[case]
    b, h, hkv, d = 2, 4, 2, 16
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, nmax, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, nmax, d)).astype(np.float32)
    k[:, :, kv_len:] = v[:, :, kv_len:] = 0.0     # unwritten cache rows
    cents = None
    if with_cents:
        kp = JR.pad_to_blocks(jnp.asarray(k), bs, axis=-2)
        cents = np.array(JR.block_centroids(kp, bs, kv_len=kv_len))
    if ties:
        # every other block's centroid is zero and the queries negative:
        # those scores tie at 0.0, the rest are exact and far apart
        q = -np.abs(q) - 0.5
        cents[:, :, ::2] = 0.0
        cents[:, :, 1::2] = np.round(cents[:, :, 1::2] * 4) / 4 + 8.0
    jcfg = JMoBAConfig(block_size=bs, top_k=top_k)
    cfg = MoBAConfig(block_size=bs, top_k=top_k)
    jc = None if cents is None else jnp.asarray(cents)
    tc = None if cents is None else _t(cents)
    want = JM.moba_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(kv_len),
        jcfg, centroids=jc)
    got = TM.moba_decode_attention(_t(q), _t(k), _t(v), kv_len, cfg,
                                   centroids=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same through a 0-d tensor length
    got_t = TM.moba_decode_attention(_t(q), _t(k), _t(v),
                                     torch.tensor(kv_len), cfg, centroids=tc)
    assert torch.equal(got_t, got)

    w_idx, w_valid, masked = _jax_selection(jnp.asarray(q), jnp.asarray(k),
                                            kv_len, jcfg, jc)
    idx, valid = TM.moba_decode_route(_t(q), _t(k), kv_len, cfg,
                                      centroids=tc)
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    if ties:      # the cut falls inside the tie: order decides the set
        above, tied = (masked > 0).sum(-1), (masked == 0).sum(-1)
        assert ((above < top_k) & (top_k < above + tied)).all()


# ------------------------------------------------ the public prefill entry
@pytest.mark.parametrize("conv", [False, True], ids=["plain", "kconv3"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_moba_attention_equals_jax(backend, conv):
    """The public ``moba_attention`` against JAX's under the same backend
    name (JAX's ``flash`` in Pallas interpret mode, the port's on CPU
    tensors through its kernels' plain versions), with the keys
    key-conv'd first when weights are given; a ragged last block (fp32
    2e-4)."""
    b, h, hkv, n, d, bs, top_k = 2, 4, 2, 70, 16, 16, 3
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, hkv, n, d)).astype(np.float32)
    w = ((rng.normal(size=(3, hkv, d)) * 0.5).astype(np.float32)
         if conv else None)
    want = JM.moba_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        JMoBAConfig(block_size=bs, top_k=top_k),
        key_conv_weights=None if w is None else jnp.asarray(w),
        impl=backend)
    got = TM.moba_attention(_t(q), _t(k), _t(v),
                            MoBAConfig(block_size=bs, top_k=top_k),
                            key_conv_weights=None if w is None else _t(w),
                            impl=backend)
    assert got.shape == (b, h, n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------- caches through layers
@pytest.fixture(scope="module")
def kconv():
    jcfg = jax_smoke_config("moba-340m", key_conv_width=3)
    cfg = get_smoke_config("moba-340m", key_conv_width=3)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = from_jax(_np_params(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def test_init_caches_leaves_equal_jax(kconv):
    jcfg, _, cfg, _ = kconv
    want = JT.init_caches(jcfg, 3, 45, dtype=jnp.float32)
    got = TT.init_caches(cfg, 3, 45, dtype=torch.float32, device="cpu")
    assert set(got) == set(want)
    for slot, jc in want.items():
        assert set(got[slot]) == set(jc), slot
        assert got[slot]["len"] == 0 and not np.asarray(jc["len"]).any()
        for name, leaf in jc.items():
            if name == "len":
                continue
            t = got[slot][name]
            assert tuple(t.shape) == leaf.shape, (slot, name)
            assert str(t.dtype).split(".")[1] == str(leaf.dtype), name
            assert not t.any(), (slot, name)
    assert "key_conv_state" in got["slot_1"]           # the MoBA slot


@pytest.mark.parametrize("kind,backend", [
    ("moba", "reference"), ("moba", "xla"), ("moba", "flash"),
    ("swa", "reference")])
def test_apply_attention_dense_cache_equals_jax(kconv, kind, backend):
    """A 33-token prefill then 4 decode steps into a 45-position cache
    (a ragged tail past block 16's edges): outputs and every cache leaf
    against JAX's ``reference``."""
    jcfg, jparams, cfg, params = kconv
    slot = f"slot_{cfg.layer_pattern.index(kind)}"
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][slot]["attn"])
    tp = TT._group(params["blocks"][slot]["attn"], 0)
    b, n, max_len = 2, 33, 45
    jcache = JL.init_cache(jcfg, kind, b, max_len, dtype=jnp.float32)
    tcache = TL.init_cache(cfg, kind, b, max_len, dtype=torch.float32,
                           device="cpu")
    rng = np.random.default_rng(7)
    xs = [rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)]
    xs += [rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
           for _ in range(4)]
    for i, x in enumerate(xs):
        start = tcache["len"]
        pos = np.arange(x.shape[1]) + start
        jo, jcache = JL.apply_attention(jp, jnp.asarray(x), jcfg, kind,
                                        positions=jnp.asarray(pos),
                                        cache=jcache, backend="reference")
        to, tcache = TL.apply_attention(tp, _t(x), cfg, kind,
                                        positions=_t(pos), cache=tcache,
                                        backend=backend)
        assert tcache["len"] == int(jcache["len"]) == start + x.shape[1]
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL,
                                   err_msg=f"output, call {i}")
        for name, leaf in jcache.items():
            if name != "len":
                np.testing.assert_allclose(
                    tcache[name].numpy(), np.asarray(leaf), **TOL,
                    err_msg=f"{name}, call {i}")
    if kind == "moba":
        assert set(tcache) == {"k", "v", "len", "centroids",
                               "key_conv_state"}


# ------------------------------------------------------------ serve_fixed
# A divergence inside the reference, not followed here: JAX's fixed loop
# on its ``flash`` backend hands the whole max_len cache to flash_moba,
# which takes the queries as the keys' suffix, so the 33 queries sit at
# positions 8..40 over zero rows.  serve_fixed("moba-340m", batch=3,
# prompt_len=33, gen=8) row 0 is [193, 182, 236, 188, 57, 188, 230, 90]
# under reference, xla and the engine, and [20, 230, 111, 66, 58, 106,
# 252, 58] under JAX flash (rows 1 and 2 agree).  The port's dense MoBA
# prefill attends over the valid prefix on every backend, so its flash
# equals the reference.
FIXED = dict(batch=3, prompt_len=33, gen=8, smoke=True)


@pytest.fixture(scope="module", params=["moba-340m", "qwen3-0.6b"])
def fixed_case(request):
    arch = request.param
    want = np.asarray(JS.serve_fixed(arch, attn_backend="reference",
                                     **FIXED))
    jparams = JT.init_lm(jax.random.PRNGKey(0), jax_smoke_config(arch))
    return arch, _np_params(jparams), want


def _jax_weights(monkeypatch, np_params):
    """The port's entry points draw their own weights; give them JAX's
    (seed 0, the entry points' default)."""
    monkeypatch.setattr(TT, "init_lm", lambda gen, cfg: from_jax(
        np_params, cfg, device=gen.device))


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_fixed_equals_jax_reference(fixed_case, backend, monkeypatch):
    arch, np_params, want = fixed_case
    _jax_weights(monkeypatch, np_params)
    got = TS.serve_fixed(arch, attn_backend=backend, device="cpu", **FIXED)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_serve_fixed_equals_paged_engine(fixed_case, monkeypatch):
    """``test_paged_engine_matches_fixed_batch`` on the port: the engine
    (``serve``) and the fixed loop (``use_engine="never"``) give the same
    tokens, the JAX fixed loop's."""
    arch, np_params, want = fixed_case
    _jax_weights(monkeypatch, np_params)
    engine = TS.serve(arch, device="cpu", **FIXED)
    fixed = TS.serve(arch, device="cpu", use_engine="never", **FIXED)
    np.testing.assert_array_equal(engine, want)
    np.testing.assert_array_equal(fixed, want)


@pytest.mark.parametrize("option,value", [
    ("shards", 2), ("kv_dtype", "int8"), ("route_policy", "snr:pfail=0.01"),
    ("prefill_chunk", 16), ("prefix_cache", True), ("swap_bytes", 0)])
def test_fixed_loop_refuses_engine_options(option, value):
    """The fixed loop keeps dense caches: ``serve`` refuses an engine
    option set away from its default rather than drop it."""
    with pytest.raises(UnsupportedFeatureError) as ei:
        TS.serve("moba-340m", device="cpu", use_engine="never",
                 **{option: value}, **FIXED)
    assert ei.value.feature == option


def _jax_loop(jcfg, jparams, prompts, gen, max_len):
    prefill = jax.jit(JSt.make_prefill_step(jcfg, backend="reference"))
    decode = jax.jit(JSt.make_decode_step(jcfg, backend="reference"))
    caches = JT.init_caches(jcfg, prompts.shape[0], max_len,
                            dtype=jnp.float32)
    logits, caches = prefill(jparams, jnp.asarray(prompts), caches)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(gen - 1):
        tok, caches = decode(jparams, tok, caches)
        out.append(tok)
    return np.asarray(logits), np.asarray(jnp.concatenate(out, 1))


def _port_loop(cfg, params, prompts, gen, max_len, backend):
    prefill = TSt.make_prefill_step(cfg, backend=backend)
    decode = TSt.make_decode_step(cfg, backend=backend)
    caches = TT.init_caches(cfg, prompts.shape[0], max_len,
                            dtype=torch.float32, device="cpu")
    logits, caches = prefill(params, _t(prompts), caches)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(gen - 1):
        tok, caches = decode(params, tok, caches)
        assert tok.dtype == torch.int32 and tok.shape == (len(prompts), 1)
        out.append(tok)
    assert caches["slot_0"]["len"] == prompts.shape[1] + gen - 1
    return logits.numpy(), torch.cat(out, 1).numpy()


@pytest.fixture(scope="module")
def kconv_loop(kconv):
    jcfg, jparams, _, _ = kconv
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, jcfg.vocab_size, (3, 37), dtype=np.int32)
    return prompts, _jax_loop(jcfg, jparams, prompts, 8, 45)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kconv3_step_loop_equals_jax(kconv, kconv_loop, backend):
    """kconv3 (``serve_fixed`` takes only an arch name): the step
    builders' loop against JAX's ``reference`` loop, and the port's paged
    engine on the same prompts."""
    _, _, cfg, params = kconv
    prompts, (want_logits, want) = kconv_loop
    logits, got = _port_loop(cfg, params, prompts, 8, 45, backend)
    np.testing.assert_allclose(logits, want_logits, **TOL)
    np.testing.assert_array_equal(got, want)
    eng = Engine(cfg, params, EngineConfig(max_seqs=3, max_seq_len=48,
                                           attn_backend=backend),
                 device="cpu")
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.run()
    np.testing.assert_array_equal(np.stack([r.out for r in reqs]), want)
