"""Quantized int8/fp8 page pools of the PyTorch port against the JAX
package, on the same numpy-made inputs.

* ``core/quantization.py``: scales and payload bytes equal to the JAX
  package's as its engine runs them (under ``jit``, where XLA turns
  ``amax / qmax`` into ``amax · (1/qmax)``), ties included (both round
  half to even),
  the all-zero page (scale 1.0) and the partial page whose stale
  positions must not reach the scale (``tests/test_quantized_pages.py``);
* ``serving/paged_cache.py``: fresh and chunked prefill appends and
  decode appends leave byte-equal payloads, equal scales and centroids
  in both packages, and the quantized pool's fresh-prefill and decode
  centroids are byte-equal to the fp32 pool's; swap moves the scales;
* the gathers dequantize as JAX's: the plain quantized decode against
  the JAX XLA path (1e-5) and both Pallas grids in interpret mode (1e-3,
  ``KERNEL_TOL`` of ``tests/test_quantized_pages.py``), the windowed SWA
  decode, the dense gather and the chunked-prefill attention;
* the engine's greedy tokens from int8/fp8 pools equal the JAX engine's
  under ``xla`` and ``flash``, with chunked prefill and with swap
  preemption; ``reference`` refuses quantized pools as in JAX.

The CUDA kernel's dequant path runs only on the card (``chip_smoke.py``);
its tables, replayed here with dequantized pages, give the plain decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import backends as JB
from repro.core import moba as JM
from repro.core import quantization as JQ
from repro.kernels import moba_decode as JMD
from repro.models import transformer as JT
from repro.serving import paged_cache as JPC
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.scheduler import \
    UnsupportedFeatureError as JUnsupportedFeatureError
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax
from repro_torch.core import backends as TB
from repro_torch.core import moba as TM
from repro_torch.core import quantization as TQ
from repro_torch.kernels import moba_decode as TMD
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import UnsupportedFeatureError
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUANT = ("int8", "fp8")
KERNEL_TOL = 1e-3        # tests/test_quantized_pages.py:43
PLAIN_TOL = 1e-5         # same fp32 math in both packages
J_APPEND_PREFILL = jax.jit(JPC.paged_append_prefill)
J_APPEND_DECODE = jax.jit(JPC.paged_append_decode)
J_SCALE = jax.jit(JQ.compute_scale, static_argnums=(1, 2))
J_QUANT = jax.jit(JQ.quantize, static_argnums=(2,))
JCFG = jax_smoke_config("moba-340m")
CFG = get_smoke_config("moba-340m")
PS = 16                  # the smoke config's block size == page size


def _bytes(x) -> np.ndarray:
    """Raw bytes of a JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _jt(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ quantization
def _quant_case(case):
    rng = np.random.default_rng(0)
    if case == "normal":            # extreme scales on two of the pages
        x = rng.normal(0, 3.0, size=(4, 16, 2, 8)).astype(np.float32)
        x[1] *= 1e-3
        x[2] *= 1e4
        return x, None
    if case == "zero":
        return np.zeros((2, 8, 2, 4), np.float32), None
    # a partial page: stale positions past the valid prefix are huge
    x = np.concatenate([rng.normal(0, 2.0, size=(1, 4, 1, 2)),
                        np.full((1, 4, 1, 2), 1e6)], axis=1)
    where = (np.arange(8) < 4)[None, :, None, None]
    return x.astype(np.float32), where


@pytest.mark.parametrize("case", ["normal", "zero", "partial"])
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quantize_bytes_equal_jax(kv_dtype, case):
    x, where = _quant_case(case)
    jx, tx = _jt(x)
    jw, tw = (None, None) if where is None else _jt(where)
    js = J_SCALE(jx, (1, 3), kv_dtype, where=jw)
    ts = TQ.compute_scale(tx, (1, 3), kv_dtype, where=tw)
    np.testing.assert_array_equal(_bytes(ts), _bytes(js))
    if case == "zero":
        assert (ts == 1.0).all()
    if case == "partial":           # the stale 1e6 never reaches the scale
        assert float(ts.max()) < 1.0
    jp = J_QUANT(jx, js[:, None, :, None], kv_dtype)
    tp = TQ.quantize(tx, ts[:, None, :, None], kv_dtype)
    assert tp.dtype == TQ.payload_dtype(kv_dtype)
    np.testing.assert_array_equal(_bytes(tp), _bytes(jp))
    np.testing.assert_array_equal(
        TQ.dequantize(tp, ts[:, None, :, None]).numpy(),
        np.asarray(JQ.dequantize(jp, js[:, None, :, None])))


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quantize_ties_round_half_even_as_jax(kv_dtype):
    """Exact ties of both grids: int8 halves, and e4m3 midpoints (1.0625
    between 1 and 1.125, 17 between 16 and 18, ...), plus the clip."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.5, 300.0,
                  1.0625, 1.1875, 17.0, 19.0, -17.0, 500.0, -500.0,
                  0.0], np.float32)
    jx, tx = _jt(x)
    jp = J_QUANT(jx, jnp.float32(1.0), kv_dtype)
    tp = TQ.quantize(tx, torch.tensor(1.0), kv_dtype)
    np.testing.assert_array_equal(_bytes(tp), _bytes(jp))
    if kv_dtype == "int8":
        assert tp[:8].tolist() == [0, 2, 2, 0, -2, 126, 127, 127]
    else:
        assert tp.float()[8:14].tolist() == [1.0, 1.25, 16.0, 20.0, -16.0,
                                             448.0]


def test_payload_dtype_and_kv_dtype_of():
    assert TQ.payload_dtype("int8") is torch.int8
    assert TQ.payload_dtype("fp8") is torch.float8_e4m3fn
    assert TQ.kv_dtype_of(torch.float8_e4m3fn) == "fp8"
    assert TQ.kv_dtype_of(torch.bfloat16) == "fp32"
    assert TQ.QMAX == JQ.QMAX
    with pytest.raises(ValueError, match="quantized modes"):
        TQ.payload_dtype("fp32")


# ------------------------------------------------------------- page pools
def _pools(kv_dtype, num_pages):
    j = JPC.init_page_pool(JCFG, num_pages, PS, with_centroids=True,
                           dtype=jnp.float32, kv_dtype=kv_dtype)
    t = TPC.init_page_pool(CFG, num_pages, PS, with_centroids=True,
                           dtype=torch.float32, device="cpu",
                           kv_dtype=kv_dtype)
    return j, t


def _assert_pools_equal(jpool, tpool):
    assert set(jpool) == set(tpool)
    for name in ("pages_k", "pages_v"):
        np.testing.assert_array_equal(_bytes(tpool[name]),
                                      _bytes(jpool[name]), err_msg=name)
    for name in ("scales_k", "scales_v"):
        if name in jpool:
            np.testing.assert_array_equal(_bytes(tpool[name]),
                                          _bytes(jpool[name]), err_msg=name)
    np.testing.assert_allclose(tpool["centroids"].numpy(),
                               np.asarray(jpool["centroids"]), rtol=1e-6,
                               atol=1e-6)


def _table(kv_lens, npg, num_pages, rng):
    free = list(range(num_pages))
    rng.shuffle(free)
    table = np.full((len(kv_lens), npg), -1, np.int32)
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // PS)):
            table[i, j] = free.pop()
    return table


def _filled(kv_dtype, kv_lens=(37, 16, 5, 61), npg=8, num_pages=32,
            seed=7):
    """Both packages' pools after one fresh prefill of the same keys and
    values, the block table and the lengths, as numpy."""
    rng = np.random.default_rng(seed)
    hkv, d = CFG.num_kv_heads, CFG.resolved_head_dim
    kv_lens = np.asarray(kv_lens, np.int32)
    b = len(kv_lens)
    table = _table(kv_lens, npg, num_pages, rng)
    kc = rng.normal(size=(b, hkv, npg * PS, d)).astype(np.float32)
    vc = rng.normal(size=(b, hkv, npg * PS, d)).astype(np.float32)
    j, t = _pools(kv_dtype, num_pages)
    j = J_APPEND_PREFILL(j, jnp.asarray(table), jnp.asarray(kv_lens),
                         jnp.asarray(kc), jnp.asarray(vc))
    TPC.paged_append_prefill(t, torch.from_numpy(table),
                             torch.from_numpy(kv_lens), torch.from_numpy(kc),
                             torch.from_numpy(vc))
    q = rng.normal(size=(b, CFG.num_heads, 1, d)).astype(np.float32)
    return j, t, table, kv_lens, q


def test_pool_layout():
    j, t = _pools("int8", 8)
    assert t["pages_k"].dtype == torch.int8
    assert t["scales_k"].shape == (8, CFG.num_kv_heads)
    assert (t["scales_v"] == 1.0).all() and t["scales_v"].dtype == \
        torch.float32
    assert t["centroids"].dtype == torch.float32
    assert {"scales_k", "scales_v"} <= set(TPC.PAGE_LEAVES)
    _, t8 = _pools("fp8", 8)
    assert t8["pages_v"].dtype == torch.float8_e4m3fn
    grouped = TPC.init_page_pool(CFG, 8, PS, with_centroids=False,
                                 dtype=torch.float32, device="cpu",
                                 kv_dtype="fp8", groups=3)
    assert grouped["scales_k"].shape == (3, 8, CFG.num_kv_heads)
    plain = TPC.init_page_pool(CFG, 8, PS, with_centroids=True,
                               dtype=torch.float32, device="cpu")
    assert "scales_k" not in plain
    with pytest.raises(ValueError, match="kv_dtype"):
        TPC.init_page_pool(CFG, 8, PS, with_centroids=True, device="cpu",
                           kv_dtype="int4")


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_prefill_and_decode_appends_equal_jax(kv_dtype):
    """A fresh prefill, then three decode appends (one row inactive):
    pools equal to JAX's after each, and centroids byte-equal to the
    port's own fp32 pool fed the same keys."""
    j, t, table, kv_lens, _ = _filled(kv_dtype)
    _assert_pools_equal(j, t)
    _, t32, *_ = _filled("fp32")
    assert torch.equal(t["centroids"], t32["centroids"])
    rng = np.random.default_rng(11)
    b, hkv, d = len(kv_lens), CFG.num_kv_heads, CFG.resolved_head_dim
    active = np.array([True, True, False, True])
    for _ in range(3):
        kt = rng.normal(size=(b, hkv, 1, d)).astype(np.float32)
        vt = rng.normal(size=(b, hkv, 1, d)).astype(np.float32)
        j = J_APPEND_DECODE(j, jnp.asarray(table), jnp.asarray(kv_lens),
                            jnp.asarray(active), jnp.asarray(kt),
                            jnp.asarray(vt))
        args = (torch.from_numpy(table), torch.from_numpy(kv_lens),
                torch.from_numpy(active), torch.from_numpy(kt),
                torch.from_numpy(vt))
        TPC.paged_append_decode(t, *args)
        TPC.paged_append_decode(t32, *args)
        kv_lens = kv_lens + active
        _assert_pools_equal(j, t)
        assert torch.equal(t["centroids"], t32["centroids"])


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_chunked_prefill_append_equal_jax(kv_dtype):
    """Two chunks, the second starting mid-page: the touched tail page is
    dequantized, extended and requantized as in JAX."""
    rng = np.random.default_rng(3)
    hkv, d, npg, num_pages = CFG.num_kv_heads, CFG.resolved_head_dim, 6, 24
    total = np.array([45, 30, 9], np.int32)
    first = np.array([21, 16, 9], np.int32)
    table = _table(total, npg, num_pages, rng)
    j, t = _pools(kv_dtype, num_pages)
    kv0 = np.zeros(3, np.int32)
    for kv_len, q_len in ((kv0, first), (first, total - first)):
        length = int(q_len.max()) or 1
        kc = rng.normal(size=(3, hkv, length, d)).astype(np.float32)
        vc = rng.normal(size=(3, hkv, length, d)).astype(np.float32)
        j = J_APPEND_PREFILL(j, jnp.asarray(table), jnp.asarray(q_len),
                             jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(kv_len))
        TPC.paged_append_prefill(t, torch.from_numpy(table),
                                 torch.from_numpy(q_len),
                                 torch.from_numpy(kc), torch.from_numpy(vc),
                                 kv_len=torch.from_numpy(kv_len))
        _assert_pools_equal(j, t)


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_swap_moves_scales(kv_dtype):
    """Swap-out and swap-in of a page carry its scales with the payload,
    so the restored page dequantizes as before."""
    _, t, table, *_ = _filled(kv_dtype)
    caches = {"slot_0": {k: v[None].clone() for k, v in t.items()}}
    src = [int(table[0, 0]), int(table[3, 1])]
    free = sorted(set(range(32)) - set(table[table >= 0].tolist()))[:2]
    snap = TPC.gather_pages_host(caches, src)
    assert ("slot_0", "scales_k") in snap and ("slot_0", "scales_v") in snap
    TPC.scatter_pages_device(caches, free, snap)
    pool = caches["slot_0"]
    for name in (n for n in TPC.PAGE_LEAVES if n in pool):
        np.testing.assert_array_equal(_bytes(pool[name][0, free]),
                                      _bytes(pool[name][0, src]))


# ----------------------------------------------------------------- gathers
def _route_args(q, pool, table, kv_lens, torch_side):
    if torch_side:
        return (torch.from_numpy(q), pool["pages_k"], pool["pages_v"],
                pool["centroids"], torch.from_numpy(table),
                torch.from_numpy(kv_lens), CFG.attention.moba)
    return (jnp.asarray(q), pool["pages_k"], pool["pages_v"],
            pool["centroids"], jnp.asarray(table), jnp.asarray(kv_lens),
            JCFG.attention.moba)


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quantized_decode_equals_jax(kv_dtype):
    """The plain quantized decode against JAX's XLA path, and the decode
    wrapper on CPU tensors against both Pallas grids (interpret mode)."""
    j, t, table, kv_lens, q = _filled(kv_dtype)
    jargs = _route_args(q, j, table, kv_lens, False)
    targs = _route_args(q, t, table, kv_lens, True)
    jsc = dict(scales_k=j["scales_k"], scales_v=j["scales_v"])
    tsc = dict(scales_k=t["scales_k"], scales_v=t["scales_v"])
    got = TM.moba_paged_decode_attention(*targs, **tsc).numpy()
    want = np.asarray(JM.moba_paged_decode_attention(*jargs, **jsc))
    np.testing.assert_allclose(got, want, atol=PLAIN_TOL, rtol=PLAIN_TOL)
    for grid in ("grouped", "flat"):
        kern = np.asarray(JMD.moba_paged_decode_pallas(*jargs, grid=grid,
                                                       **jsc))
        wrap = TMD.moba_paged_decode(*targs, grid=grid, **tsc).numpy()
        np.testing.assert_allclose(wrap, kern, atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quantized_gathers_equal_jax(kv_dtype):
    """The windowed SWA decode, the dense gather and the chunked-prefill
    MoBA attention dequantize as JAX's."""
    j, t, table, kv_lens, q = _filled(kv_dtype)
    jt_table, tt_table = jnp.asarray(table), torch.from_numpy(table)
    jl, tl = jnp.asarray(kv_lens), torch.from_numpy(kv_lens)
    got = TPC.swa_windowed_decode_attention(torch.from_numpy(q), t,
                                            tt_table, tl, 31)
    want = JPC.swa_windowed_decode_attention(jnp.asarray(q), j, jt_table,
                                             jl, 31)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)
    for a, b in zip(TPC.paged_gather_kv(t, tt_table),
                    JPC.paged_gather_kv(j, jt_table)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a 5-token chunk whose keys are already appended, at each row's end
    rng = np.random.default_rng(5)
    q_len = np.minimum(kv_lens, 5).astype(np.int32)
    kv0 = (kv_lens - q_len).astype(np.int32)
    qc = rng.normal(size=(len(kv_lens), CFG.num_heads, 5,
                          CFG.resolved_head_dim)).astype(np.float32)
    got = TM.moba_paged_prefill_attention(
        torch.from_numpy(qc), t["pages_k"], t["pages_v"], t["centroids"],
        tt_table, torch.from_numpy(kv0), torch.from_numpy(q_len),
        CFG.attention.moba, scales_k=t["scales_k"], scales_v=t["scales_v"])
    want = JM.moba_paged_prefill_attention(
        jnp.asarray(qc), j["pages_k"], j["pages_v"], j["centroids"],
        jt_table, jnp.asarray(kv0), jnp.asarray(q_len), JCFG.attention.moba,
        scales_k=j["scales_k"], scales_v=j["scales_v"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)


def _replay_dequant(q, pool, kv_len, phys, base, n_uniq, scale):
    """The CUDA kernel's reading of its tables with dequantized pages:
    each (batch, kv head) row walks its n_uniq union pages, scaling page
    u's tile by scales[phys[u], head]; padding slots are never read."""
    b, h, _, d = q.shape
    _, ps, hkv, _ = pool["pages_k"].shape
    g = h // hkv
    out = torch.zeros(b * hkv, g, d)
    qr = q[:, :, 0].reshape(b * hkv, g, d)
    for row in range(b * hkv):
        bi, hi = divmod(row, hkv)
        n = int(n_uniq[row])
        pg = phys[row, :n].long()
        k = (pool["pages_k"][pg, :, hi].float()
             * pool["scales_k"][pg, hi][:, None, None]).reshape(n * ps, d)
        v = (pool["pages_v"][pg, :, hi].float()
             * pool["scales_v"][pg, hi][:, None, None]).reshape(n * ps, d)
        pos = base[row, :, :n, None] + torch.arange(ps)
        mask = (pos < kv_len[bi]).reshape(g, n * ps)
        s = torch.where(mask, qr[row] @ k.T * scale, TM.NEG_INF)
        out[row] = (torch.softmax(s, -1) * mask) @ v
    return out.reshape(b, h, 1, d)


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_kernel_tables_reproduce_quantized_decode(kv_dtype):
    _, t, table, kv_lens, q = _filled(kv_dtype)
    targs = _route_args(q, t, table, kv_lens, True)
    qt, pk, _, cents, tbl, kvl, cfg = targs
    idx, val = TM.moba_paged_route(qt, cents, tbl, kvl, cfg, page_size=PS)
    phys, base, n_uniq = TMD.decode_tables(qt, pk, tbl, idx, val)
    got = _replay_dequant(qt, t, kvl, phys, base, n_uniq,
                          qt.shape[-1] ** -0.5)
    want = TM.moba_paged_decode_attention(
        *targs, scales_k=t["scales_k"], scales_v=t["scales_v"])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def model():
    jparams = JT.init_lm(jax.random.PRNGKey(0), JCFG)
    params = from_jax(jax.tree.map(np.asarray, jparams), CFG, device="cpu")
    return jparams, params


def _tokens(engine_cls, ecfg_cls, cfg, params, prompts, gen, **ecfg):
    kw = {"device": "cpu"} if engine_cls is Engine else {}
    eng = engine_cls(cfg, params, ecfg_cls(**ecfg), **kw)
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    return [list(r.out) for r in reqs], eng


def _port_tokens_and_logits(params, prompts, gen, monkeypatch, **ecfg):
    """The port engine's streams, and the logits row each decode token
    was taken from, keyed (request index, token position).  Decode is
    synchronous here, so a request's position is ``len(r.out)`` when its
    step is dispatched."""
    from repro_torch.models import transformer as TT
    eng = Engine(CFG, params, EngineConfig(**ecfg), device="cpu")
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    index = {id(r): i for i, r in enumerate(reqs)}
    rows = {}
    decode_step = TT.decode_step

    def recording(*args, **kw):
        logits, caches = decode_step(*args, **kw)
        for r in eng.sched.running:
            if r.state == "running" and r.slot >= 0:
                rows[(index[id(r)], len(r.out))] = logits[r.slot, -1].clone()
        return logits, caches

    monkeypatch.setattr(TT, "decode_step", recording)
    eng.run()
    return [list(r.out) for r in reqs], rows, eng


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.int32) for n in lens]


ENGINE_CASES = {
    "plain": (dict(max_seqs=3, max_seq_len=64), (40, 33, 21), 10),
    "chunked": (dict(max_seqs=3, max_seq_len=64, prefill_chunk=16),
                (40, 33, 21), 8),
    "swap": (dict(max_seqs=3, max_seq_len=64, num_pages=8,
                  swap_bytes=64 << 20), (40, 35, 30), 14),
}
# fp8 near-tie bound on the smoke model's logits (~2 in size).  The two
# packages' K/V projections differ in the last bits, and e4m3 rounds a
# value that sits on a grid midpoint either way: one element then moves
# by a whole e4m3 step (up to 1/8 of its size).  The decode logits then
# move a little, so a greedy pick whose runner-up is within NEAR_TIE can
# differ; int8 streams must be equal.
NEAR_TIE = {"int8": 0.0, "fp8": 1e-2}


@pytest.mark.parametrize("case", ENGINE_CASES)
@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_engine_tokens_equal_jax(model, kv_dtype, backend, case,
                                 monkeypatch):
    """Greedy streams equal to the JAX engine's.  A stream may part from
    the reference only at a decode step where the port's own logits put
    the reference's token within ``NEAR_TIE`` of its pick (fp8); past
    that point the two contexts differ and are not compared."""
    ecfg, lens, gen = ENGINE_CASES[case]
    jparams, params = model
    prompts = _prompts(lens, seed=5)
    ecfg = dict(ecfg, attn_backend=backend, kv_dtype=kv_dtype,
                dispatch_ahead=0)
    got, rows, eng = _port_tokens_and_logits(params, prompts, gen,
                                             monkeypatch, **ecfg)
    want, _ = _tokens(JEngine, JEngineConfig, JCFG, jparams, prompts, gen,
                      **ecfg)
    exact = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == gen
        p = next((p for p in range(gen) if g[p] != w[p]), None)
        if p is None:
            exact += 1
            continue
        assert p > 0, "the first token comes from unquantized prefill"
        row = rows[(i, p)]
        gap = float(row[g[p]] - row[w[p]])
        assert gap <= NEAR_TIE[kv_dtype], (i, p, g[p], w[p], gap)
    assert exact >= len(prompts) - 1
    pool = eng.caches["slot_0"]
    assert pool["pages_k"].dtype == TQ.payload_dtype(kv_dtype)
    if case == "swap":
        assert eng.stats["preemptions"] > 0
        assert eng.stats["swap_restores"] > 0


def test_reference_refuses_quantized_pools(model):
    _, params = model
    for be in (JB, TB):
        with pytest.raises(be.BackendCapabilityError, match="kv_dtype"):
            be.resolve("reference", kind="moba", phase="decode",
                       cache="paged", kv_dtype="int8")
        for name in ("xla", "flash"):
            assert be.resolve(name, kind="swa", phase="prefill",
                              cache="paged", kv_dtype="fp8").name == name
    jparams, params = model
    with pytest.raises(JUnsupportedFeatureError) as je:
        JEngine(JCFG, jparams, JEngineConfig(kv_dtype="int8"))
    with pytest.raises(UnsupportedFeatureError) as te:
        Engine(CFG, params, EngineConfig(kv_dtype="int8"), device="cpu")
    assert te.value.feature == je.value.feature == "attn_backend"
