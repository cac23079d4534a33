"""Key convolution (paper App. B) in the PyTorch port against the JAX
package, on the same numpy-made inputs and converted weights.

* ``core/key_conv.py``: every function against JAX's at widths 2, 3, 5
  and 7 (fp32, 2e-4), and the port's own bit-equalities: a zero state
  equals one-shot, chunks of 7 and 24 equal one-shot, the advanced ring
  holds the last W-1 raw keys, a q_len 0 row keeps its ring, decode
  steps equal one-shot, in fp32 and bf16;
* the kconv3 smoke model: logits, loss and every gradient leaf
  (``key_conv`` included, 5e-3 of the leaf's max |g|) under
  ``reference``, ``xla`` and ``flash`` (on CPU tensors ``flash`` runs its
  kernels' plain versions); paged prefill and decode logits and pools,
  the per-slot ring included; ``train`` moves the conv weights;
* the engine: greedy tokens equal the JAX engine's one-shot, with
  chunked prefill (7 and 16), with swap and recompute preemption and
  from int8 pools;
* the ring's layout, its swap snapshot, and the capability query.
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
from repro.core import key_conv as JK
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.core import backends as B
from repro_torch.core import key_conv as TK
from repro_torch.launch.train import train
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import UnsupportedFeatureError
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-4, rtol=2e-4)         # tests/test_kernels.py:24 (fp32)
WIDTHS = (2, 3, 5, 7)
BACKENDS = ("reference", "xla", "flash")
DTYPES = (torch.float32, torch.bfloat16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _conv_case(width, seed, b=2, hkv=2, n=29, d=16):
    """Weights large enough that the conv moves every key.  Hkv·d is 32
    floats a position, as in every config (``core/key_conv.py`` says why
    the CPU's bit-equalities need that)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(width, hkv, d)) * 0.5).astype(np.float32)
    k = rng.normal(size=(b, hkv, n, d)).astype(np.float32)
    state = rng.normal(size=(b, hkv, width - 1, d)).astype(np.float32)
    return w, k, state


# -------------------------------------------------- the functions vs JAX
@pytest.mark.parametrize("width", WIDTHS)
def test_init_key_conv_shape_and_scale(width):
    want = JK.init_key_conv(jax.random.PRNGKey(0), width, 3, 8)
    got = TK.init_key_conv(torch.Generator().manual_seed(0), width, 3, 8)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    # N(0, 1)·0.02/W in both: the scale, not the draws, must agree
    assert float(got.abs().max()) <= 6 * 0.02 / width
    assert float(got.std()) == pytest.approx(float(np.std(want)), rel=0.5)
    lead = TK.init_key_conv(torch.Generator(), width, 3, 8, lead=(4,))
    assert tuple(lead.shape) == (4,) + want.shape


@pytest.mark.parametrize("width", WIDTHS)
def test_apply_key_conv_matches_jax(width):
    w, k, _ = _conv_case(width, 0)
    want = JK.apply_key_conv(jnp.asarray(w), jnp.asarray(k))
    np.testing.assert_allclose(TK.apply_key_conv(_t(w), _t(k)).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("width", WIDTHS)
def test_apply_key_conv_with_state_matches_jax(width):
    w, k, state = _conv_case(width, 1)
    want = JK.apply_key_conv_with_state(jnp.asarray(w), jnp.asarray(k),
                                        jnp.asarray(state))
    got = TK.apply_key_conv_with_state(_t(w), _t(k), _t(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("width", WIDTHS)
def test_key_conv_state_update_matches_jax(width):
    w, k, state = _conv_case(width, 2, b=4, n=9)
    q_len = np.array([9, 0, 1, 5], np.int32)       # full, empty, ragged
    want = JK.key_conv_state_update(jnp.asarray(state), jnp.asarray(k),
                                    jnp.asarray(q_len))
    got = TK.key_conv_state_update(_t(state), _t(k), _t(q_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("width", WIDTHS)
def test_apply_key_conv_decode_matches_jax(width):
    w, k, state = _conv_case(width, 3, n=1)
    want_k, want_s = JK.apply_key_conv_decode(
        jnp.asarray(w), jnp.asarray(k), jnp.asarray(state))
    got_k, got_s = TK.apply_key_conv_decode(_t(w), _t(k), _t(state))
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), **TOL)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_key_conv_state_init_matches_jax():
    want = JK.key_conv_state_init(3, 2, 4, 8, dtype=jnp.float32)
    got = TK.key_conv_state_init(3, 2, 4, 8, dtype=torch.float32,
                                 device="cpu")
    assert tuple(got.shape) == want.shape and not got.any()


# ------------------------------------------------ the port's bit-equalities
def _typed(width, seed, dtype, **kw):
    w, k, state = _conv_case(width, seed, **kw)
    return _t(w), _t(k).to(dtype), _t(state).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_zero_state_bit_equals_one_shot(width, dtype):
    w, k, state = _typed(width, 4, dtype)
    got = TK.apply_key_conv_with_state(w, k, torch.zeros_like(state))
    assert torch.equal(got, TK.apply_key_conv(w, k))


@pytest.mark.parametrize("chunk", [7, 24])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_chunked_bit_equals_one_shot(width, dtype, chunk):
    """Chunks carried through the ring give the one-shot keys bit for
    bit, and the ring ends as the last W-1 raw keys."""
    w, k, state = _typed(width, 5, dtype, n=50)
    n = k.shape[2]
    ring = torch.zeros_like(state)
    outs = []
    for s in range(0, n, chunk):
        part = k[:, :, s:s + chunk]
        outs.append(TK.apply_key_conv_with_state(w, part, ring))
        q_len = torch.full((k.shape[0],), part.shape[2])
        ring = TK.key_conv_state_update(ring, part, q_len)
    assert torch.equal(torch.cat(outs, dim=2), TK.apply_key_conv(w, k))
    assert torch.equal(ring, k[:, :, n - (width - 1):])


@pytest.mark.parametrize("width", WIDTHS)
def test_chunked_tap_sums_bit_equal_at_any_shape(width):
    """Hkv·d of 24 floats: the fp32 tap sums of chunks of 7 still equal
    one-shot's bit for bit (only the CPU's SiLU tail may differ)."""
    w, k, state = _typed(width, 8, torch.float32, hkv=3, d=8, n=50)
    depth = width - 1
    full = TK._conv(w, torch.nn.functional.pad(k, (0, 0, depth, 0)), 50)
    hist = torch.cat([torch.zeros_like(state), k], dim=2)
    parts = [TK._conv(w, hist[:, :, s:s + depth + 7], min(7, 50 - s))
             for s in range(0, 50, 7)]
    assert torch.equal(torch.cat(parts, dim=2), full)


@pytest.mark.parametrize("width", WIDTHS)
def test_state_update_ragged_rows(width):
    """Row 0 advances past its 3 valid keys of a right-padded chunk; a
    q_len 0 row keeps its ring."""
    _, k, state = _typed(width, 6, torch.float32, n=6)
    got = TK.key_conv_state_update(state, k, torch.tensor([3, 0]))
    hist = torch.cat([state[0], k[0, :, :3]], dim=1)
    assert torch.equal(got[0], hist[:, 3:])
    assert torch.equal(got[1], state[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_decode_steps_bit_equal_one_shot(width, dtype):
    w, k, _ = _typed(width, 7, dtype, n=12)
    want = TK.apply_key_conv(w, k)
    ring = torch.zeros(k.shape[:2] + (width - 1, k.shape[3]), dtype=dtype)
    for t in range(k.shape[2]):
        got, ring = TK.apply_key_conv_decode(w, k[:, :, t:t + 1], ring)
        assert torch.equal(got, want[:, :, t:t + 1]), t


# ------------------------------------------------------- the kconv3 model
@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("moba-340m", key_conv_width=3)
    tcfg = get_smoke_config("moba-340m", key_conv_width=3)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(seed, b=2, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s + 1)).astype(
        np.int32)


def test_from_jax_takes_the_key_conv_leaf(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    conv = tparams["blocks"]["slot_1"]["attn"]["key_conv"]
    assert tuple(conv.shape) == (1, 3, 4, 16)       # (G, W, Hkv, d)
    assert "key_conv" not in tparams["blocks"]["slot_0"]["attn"]  # swa
    np.testing.assert_array_equal(
        conv.numpy(), np.asarray(jparams["blocks"]["slot_1"]["attn"]
                                 ["key_conv"]))
    params = jax.tree.map(np.asarray, jparams)
    del params["blocks"]["slot_1"]["attn"]["key_conv"]
    with pytest.raises(ValueError, match="key_conv"):
        from_jax(params, tcfg, device="cpu")
    init = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    assert tuple(init["blocks"]["slot_1"]["attn"]["key_conv"].shape) == \
        (1, 3, 4, 16)


def test_kconv_logits_match_jax(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    tokens = _tokens(8, s=39)[:, :-1]
    want, _, _ = JT.lm_apply(jparams, jnp.asarray(tokens), jcfg)
    got, _, _ = TT.lm_apply(tparams, _t(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kconv_loss_and_grads_match_jax(smoke, backend):
    jcfg, tcfg, jparams, tparams = smoke
    tokens = _tokens(1)
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(JT.lm_loss, has_aux=True),
        static_argnums=(2, 3))(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, backend)
    leaves = [leaf.detach().requires_grad_() for _, leaf in
              adamw.tree_leaves(tparams)]
    params = adamw.tree_like(tparams, leaves)
    loss, _ = TT.lm_loss(params, {"tokens": _t(tokens)}, tcfg,
                         backend=backend)
    grads = dict(adamw.tree_leaves(adamw.tree_like(
        params, torch.autograd.grad(loss, leaves))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(grads) == set(want)
    assert "blocks/slot_1/attn/key_conv" in grads
    for name, w in want.items():
        err = float(np.abs(grads[name].numpy() - w).max())
        assert err <= 5e-3 * max(float(np.abs(w).max()), 1e-12), (name, err)
    assert float(grads["blocks/slot_1/attn/key_conv"].abs().max()) > 0


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["one-shot", "chunk-aware"])
def test_kconv_paged_prefill_then_decode_match_jax(smoke, chunked):
    """Ragged paged prefill (one padding row, rows at slots 2 and 0),
    then three decode steps over 3 slots with one inactive: logits at
    the fp32 tolerance; pages, centroids and the per-slot ring equal."""
    jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(9)
    ps, num_pages, max_seqs = 16, 12, 3
    q_len = np.array([40, 23, 0], np.int32)
    slots = np.array([2, 0, -1], np.int32)
    table = np.array([[5, 2, 9, 11], [0, 7, -1, -1], [-1] * 4], np.int32)
    tokens = np.zeros((3, 48), np.int32)
    for i, n in enumerate(q_len):
        tokens[i, :n] = rng.integers(0, 256, n)
    jc = JT.init_paged_caches(jcfg, num_pages, ps, dtype=jnp.float32,
                              max_seqs=max_seqs)
    tc = TT.init_paged_caches(tcfg, num_pages, ps, dtype=torch.float32,
                              device="cpu", max_seqs=max_seqs)
    zeros = np.zeros(3, np.int32)
    active = q_len > 0
    pos = np.arange(48) if not chunked else zeros[:, None] + np.arange(48)

    def state(table, kv, ql, act, conv, **extra):
        return {"block_table": conv(table), "kv_len": conv(kv),
                "q_len": conv(ql), "active": conv(act), **extra}

    extra = dict(chunked=chunked)
    jl, jc = JT.prefill(jparams, jnp.asarray(tokens), jcfg, jc,
                        page_state=state(table, zeros, q_len, active,
                                         jnp.asarray, **extra,
                                         slots=jnp.asarray(slots)),
                        positions=jnp.asarray(pos))
    tl, tc = TT.prefill(tparams, _t(tokens), tcfg, tc,
                        page_state=state(table, zeros, q_len, active, _t,
                                         **extra, slots=_t(slots)),
                        positions=_t(pos))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               **TOL)
    # decode rows are the slots: slot 2 holds row 0, slot 0 row 1
    dtable = table[[1, 2, 0]]
    lens = q_len[[1, 2, 0]].copy()
    act = np.array([True, False, True])
    tok = np.array([7, 0, 200], np.int32)
    for _ in range(3):
        ql = act.astype(np.int32)
        jl, jc = JT.decode_step(jparams, jnp.asarray(tok[:, None]), jcfg, jc,
                                page_state=state(dtable, lens, ql, act,
                                                 jnp.asarray))
        tl, tc = TT.decode_step(tparams, _t(tok[:, None]), tcfg, tc,
                                page_state=state(dtable, lens, ql, act, _t))
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
        lens = lens + act
    assert "key_conv_state" in tc["slot_1"]
    for slot, pool in tc.items():
        assert set(pool) == set(jc[slot])
        for name, leaf in pool.items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(
                jc[slot][name]), **TOL)


def test_train_moves_the_conv_weights():
    """``train`` starts from ``init_lm`` at its seed, so a fresh init is
    the weights it started from."""
    params, losses = train("moba-340m", steps=2, batch=2, seq=32,
                           key_conv_width=3, attn_backend="flash",
                           device="cpu")
    fresh = TT.init_lm(torch.Generator().manual_seed(0),
                       get_smoke_config("moba-340m", key_conv_width=3))
    w0 = fresh["blocks"]["slot_1"]["attn"]["key_conv"]
    w2 = params["blocks"]["slot_1"]["attn"]["key_conv"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert float((w2.detach() - w0).abs().max()) > 0


def test_train_cli_key_conv_on_cpu():
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "moba-340m", "--key-conv", "3", "--smoke", "--steps", "2",
         "--device", "cpu", "--attn-backend", "flash"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("loss") == 2


# ------------------------------------------------------------------ engine
def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.int32) for n in lens]


def _run(engine_cls, ecfg_cls, cfg, params, prompts, gen, **ecfg):
    kw = {"device": "cpu"} if engine_cls is Engine else {}
    eng = engine_cls(cfg, params, ecfg_cls(**ecfg), **kw)
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    return [list(r.out) for r in reqs], eng


ENGINE_CASES = {
    "one-shot": dict(),
    "chunk7": dict(prefill_chunk=7),
    "chunk16": dict(prefill_chunk=16),
    # tests/test_chunked_prefill.py::
    # test_key_conv_chunked_preemption_replay_exact's starved pool
    "swap": dict(num_pages=8, prefill_chunk=24),
    "recompute": dict(num_pages=8, prefill_chunk=24, swap_bytes=0),
    "int8": dict(kv_dtype="int8", prefill_chunk=16),
}


@pytest.mark.parametrize("backend,case", [
    (be, case) for be in BACKENDS for case in ENGINE_CASES
    # reference serves fp32 pools only, in both packages
    # (test_torch_quant.py pins the refusal)
    if not (be == "reference" and "kv_dtype" in ENGINE_CASES[case])])
def test_kconv_engine_tokens_equal_jax(smoke, backend, case):
    jcfg, tcfg, jparams, tparams = smoke
    kw = ENGINE_CASES[case]
    prompts = _prompts((40, 35, 30), seed=4)
    ecfg = dict(max_seqs=3, max_seq_len=64, attn_backend=backend, **kw)
    got, eng = _run(Engine, EngineConfig, tcfg, tparams, prompts, 10,
                    **ecfg)
    want, _ = _run(JEngine, JEngineConfig, jcfg, jparams, prompts, 10,
                   **ecfg)
    assert got == want
    ring = eng.caches["slot_1"]["key_conv_state"]
    assert tuple(ring.shape) == (1, 3, 4, 2, 16)
    assert ring.dtype == torch.float32            # compute dtype, even int8
    if "num_pages" in kw:
        assert eng.stats["preemptions"] > 0
        assert (eng.stats["swap_restores"] > 0) == (case == "swap")


# ------------------------------------------------------ ring and registry
def test_ring_layout_and_swap_snapshot(smoke):
    _, tcfg, _, _ = smoke
    caches = TT.init_paged_caches(tcfg, 6, 16, dtype=torch.bfloat16,
                                  device="cpu", kv_dtype="int8", max_seqs=4)
    assert "key_conv_state" not in caches["slot_0"]          # swa slot
    ring = caches["slot_1"]["key_conv_state"]
    assert tuple(ring.shape) == (1, 4, 4, 2, 16)
    assert ring.dtype == torch.bfloat16
    assert "key_conv_state" not in TPC.PAGE_LEAVES
    assert "key_conv_state" not in TT.init_paged_caches(
        tcfg, 6, 16, device="cpu")["slot_1"]                 # max_seqs 0
    ring.copy_(torch.randn(ring.shape).to(ring.dtype))
    snap = TPC.gather_ring_rows(caches, 2)
    assert set(snap) == {("slot_1", "key_conv_state")}
    TPC.scatter_ring_rows(caches, 0, snap)
    assert torch.equal(ring[:, 0], ring[:, 2])
    assert TPC.gather_ring_rows(TT.init_paged_caches(
        get_smoke_config("moba-340m"), 6, 16, device="cpu", max_seqs=4),
        0) == {}


def test_paged_attend_needs_the_ring(smoke):
    _, tcfg, _, tparams = smoke
    caches = TT.init_paged_caches(tcfg, 6, 16, dtype=torch.float32,
                                  device="cpu")
    st = {"block_table": torch.tensor([[0, 1]]),
          "kv_len": torch.zeros(1, dtype=torch.int32),
          "q_len": torch.tensor([20]), "active": torch.tensor([True]),
          "slots": torch.tensor([0])}
    with pytest.raises(UnsupportedFeatureError) as ei:
        TT.prefill(tparams, torch.zeros((1, 20), dtype=torch.int32), tcfg,
                   caches, page_state=st)
    assert ei.value.feature == "key_conv"


@pytest.mark.parametrize("backend", BACKENDS)
def test_resolve_key_conv(backend):
    for cache in ("dense", "paged"):
        for phase in ("prefill", "decode"):
            be = B.resolve(backend, kind="moba", phase=phase, cache=cache,
                           key_conv=True)
            assert be.name == backend
    assert B.get(backend).capabilities.key_conv == ("dense", "paged")
