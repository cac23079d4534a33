"""Paged MoBA decode of the PyTorch port against the JAX reference.

The port's decode wrapper (``repro_torch.kernels.moba_decode``) on CPU
tensors runs its plain version; here it is held against the reference's
Pallas kernel (both grids, interpret mode on the CPU, as
``tests/test_backends.py`` runs it) and against the reference's XLA path
on the same numpy-made pools, with the 1e-3 tolerance of
``test_backends.py``.  Routing and the page union must be index-equal,
tied centroid scores included.  The CUDA kernels run only on the card
(``chip_smoke.py``); the per-row page, offset and union tables the route
kernel writes (their plain version is ``decode_tables``) are checked
here by replaying them in PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import moba as JM
from repro.kernels import moba_decode as JMD
from repro.serving import paged_cache as JPC
from repro_torch.configs.base import MoBAConfig
from repro_torch.core import moba as TM
from repro_torch.kernels import moba_decode as TMD

ATOL = RTOL = 1e-3   # tests/test_backends.py:201
# jitted once: op-by-op JAX would compile every primitive of the append
J_APPEND_PREFILL = jax.jit(JPC.paged_append_prefill)

GEOMETRIES = {
    # G = 2, ragged tails, an inactive kv_len == 0 row, and block tables
    # shorter than top_k (npg 3 < 4): selection pads with invalid slots
    "g2-short-table": dict(kv_lens=(37, 16, 5, 48, 0), top_k=4, h=4, hkv=2,
                           d=16, ps=16, npg=3, num_pages=24),
    # G = 1 (H == Hkv), as in moba-340m, with tables longer than top_k
    "g1": dict(kv_lens=(90, 1, 16, 0, 128), top_k=3, h=4, hkv=4, d=16,
               ps=16, npg=8, num_pages=32),
}
# G = 4 with long tables, so the heads of a group pick different pages
# and the union has slots some heads must not see
DISAGREE = dict(kv_lens=(90, 70, 33, 128), top_k=2, h=8, hkv=2, d=16,
                ps=16, npg=8, num_pages=40)


def _case(geom, seed=2, tie_centroids=False):
    """One paged pool built by the reference's own prefill append (pool
    slots never written keep garbage, as in a recycled pool), as numpy."""
    rng = np.random.default_rng(seed)
    b, hkv, d, ps, npg = (len(geom["kv_lens"]), geom["hkv"], geom["d"],
                          geom["ps"], geom["npg"])
    kv_lens = np.asarray(geom["kv_lens"], np.int32)
    kc = rng.normal(size=(b, hkv, npg * ps, d)).astype(np.float32)
    vc = rng.normal(size=(b, hkv, npg * ps, d)).astype(np.float32)
    free = list(range(geom["num_pages"]))
    rng.shuffle(free)
    table = np.full((b, npg), -1, np.int32)
    for i, n in enumerate(kv_lens):
        for j in range(-(-n // ps)):
            table[i, j] = free.pop()
    shape = (geom["num_pages"], ps, hkv, d)
    cache = {"pages_k": jnp.asarray(rng.normal(size=shape), jnp.float32),
             "pages_v": jnp.asarray(rng.normal(size=shape), jnp.float32),
             "centroids": jnp.zeros(shape[:1] + shape[2:], jnp.float32)}
    cache = J_APPEND_PREFILL(cache, jnp.asarray(table),
                             jnp.asarray(kv_lens), jnp.asarray(kc),
                             jnp.asarray(vc))
    arrays = {k: np.array(v) for k, v in cache.items()}
    if tie_centroids:
        # every page of a head scores the same: the order of the top-k
        # among equal scores decides the selection
        arrays["centroids"][:] = arrays["centroids"][:1]
    q = rng.normal(size=(b, geom["h"], 1, d)).astype(np.float32)
    return q, arrays, table, kv_lens


def _jax_args(q, cache, table, kv_lens, top_k, ps):
    return (jnp.asarray(q), jnp.asarray(cache["pages_k"]),
            jnp.asarray(cache["pages_v"]), jnp.asarray(cache["centroids"]),
            jnp.asarray(table), jnp.asarray(kv_lens),
            JMoBAConfig(block_size=ps, top_k=top_k))


def _torch_args(q, cache, table, kv_lens, top_k, ps):
    return (torch.from_numpy(q), torch.from_numpy(cache["pages_k"]),
            torch.from_numpy(cache["pages_v"]),
            torch.from_numpy(cache["centroids"]), torch.from_numpy(table),
            torch.from_numpy(kv_lens), MoBAConfig(block_size=ps, top_k=top_k))


def _both(geom_name, **kw):
    geom = GEOMETRIES.get(geom_name, DISAGREE)
    q, cache, table, kv_lens = _case(geom, **kw)
    args = (q, cache, table, kv_lens, geom["top_k"], geom["ps"])
    return _jax_args(*args), _torch_args(*args), kv_lens


@pytest.mark.parametrize("grid", ["grouped", "flat"])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_decode_matches_jax_pallas(geom, grid):
    jargs, targs, kv_lens = _both(geom)
    want = np.asarray(JMD.moba_paged_decode_pallas(*jargs, grid=grid))
    got = TMD.moba_paged_decode(*targs, grid=grid).numpy()
    active = kv_lens > 0
    np.testing.assert_allclose(got[active], want[active], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_decode_matches_jax_xla(geom):
    jargs, targs, _ = _both(geom)
    want = np.asarray(JM.moba_paged_decode_attention(*jargs))
    got = TM.moba_paged_decode_attention(*targs).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_route_and_union_index_equal(geom, ties):
    """Same pages, same slot order, same validity — ties broken toward
    the lower page id in both packages."""
    jargs, targs, _ = _both(geom, tie_centroids=ties)
    ps = GEOMETRIES[geom]["ps"]
    jidx, jval = JM.moba_paged_route(*jargs[:1], *jargs[3:], page_size=ps)
    tidx, tval = TM.moba_paged_route(targs[0], *targs[3:], page_size=ps)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    npg = GEOMETRIES[geom]["npg"]
    ju, jn = JMD.union_pages(jidx, jval, npg)
    tu, tn = TMD.union_pages(tidx, tval, npg)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_union_pages_dedupes_and_compacts():
    """The reference's own example (tests/test_backends.py)."""
    idx = torch.tensor([[[[[3, 1, 3]], [[1, 1, 0]]]]])      # (1,1,2,1,3)
    valid = torch.tensor([[[[[True, True, False]],
                            [[True, False, True]]]]])
    union, n_uniq = TMD.union_pages(idx, valid, npg=8)
    assert union.shape == (1, 1, 6)
    assert int(n_uniq[0, 0]) == 3
    assert union[0, 0, :3].tolist() == [0, 1, 3]
    assert union[0, 0, 3:].tolist() == [0, 0, 0]


def _replay_kernel(q, pages_k, pages_v, kv_len, phys, base, n_uniq, scale):
    """What the CUDA kernel computes from its tables, in PyTorch: each
    (batch, kv head) row walks its n_uniq union pages; head g sees page
    u's token t iff base[g, u] + t < kv_len."""
    b, h, _, d = q.shape
    _, ps, hkv, _ = pages_k.shape
    g = h // hkv
    out = torch.zeros(b * hkv, g, d)
    qr = q[:, :, 0].reshape(b * hkv, g, d)
    for row in range(b * hkv):
        bi, hi = divmod(row, hkv)
        n = int(n_uniq[row])
        if n == 0:
            continue
        pg = phys[row, :n].long()
        k = pages_k[pg, :, hi].reshape(n * ps, d)
        v = pages_v[pg, :, hi].reshape(n * ps, d)
        pos = base[row, :, :n, None] + torch.arange(ps)       # (G,n,ps)
        mask = (pos < kv_len[bi]).reshape(g, n * ps)
        s = torch.where(mask, qr[row] @ k.T * scale, TM.NEG_INF)
        p = torch.softmax(s, -1) * mask
        out[row] = p @ v
    return out.reshape(b, h, 1, d)


@pytest.mark.parametrize("geom", list(GEOMETRIES) + ["g4-disagree"])
def test_kernel_tables_reproduce_plain_decode(geom):
    """The route kernel's physical-page, token-offset and union tables
    (from their plain version), read over the union pages as the
    attention kernel reads them, give the plain decode; rows with
    kv_len 0 give zeros."""
    _, targs, kv_lens = _both(geom)
    q, pk, pv, cents, table, kvl, cfg = targs
    idx, val = TM.moba_paged_route(q, cents, table, kvl, cfg,
                                   page_size=pk.shape[1])
    phys, base, n_uniq = TMD.decode_tables(q, pk, table, idx, val)
    assert phys.dtype == base.dtype == n_uniq.dtype == torch.int32
    if geom == "g4-disagree":    # some head must skip some union page
        npg, ps = table.shape[1], pk.shape[1]
        slots = torch.arange(phys.shape[1]) < n_uniq[:, None]
        assert ((base == npg * ps) & slots[:, None, :]).any()
    scale = q.shape[-1] ** -0.5
    got = _replay_kernel(q, pk, pv, kvl, phys, base, n_uniq, scale)
    want = TM.moba_paged_decode_attention(*targs)
    active = torch.from_numpy(kv_lens > 0)
    torch.testing.assert_close(got[active], want[active], atol=1e-5,
                               rtol=1e-5)
    assert torch.all(got[~active] == 0)


def test_kernel_contract_errors():
    """Shapes the CUDA kernel does not take raise a shaped error (the
    check runs before any launch; on the card it guards every call)."""
    def pool(ps=128, hkv=16, d=64, dtype=torch.bfloat16):
        return torch.zeros(4, ps, hkv, d, dtype=dtype)

    q = torch.zeros(2, 16, 1, 64, dtype=torch.bfloat16)
    TMD.check_contract(q, pool(), pool())                    # moba-340m
    TMD.check_contract(q.float(), pool(dtype=torch.float32),
                       pool(dtype=torch.float32))
    with pytest.raises(ValueError, match="head_dim"):
        TMD.check_contract(q[..., :32], pool(d=32), pool(d=32))
    with pytest.raises(ValueError, match="page_size"):
        TMD.check_contract(q, pool(ps=12), pool(ps=12))
    with pytest.raises(ValueError, match="GQA group"):
        TMD.check_contract(q, pool(hkv=1), pool(hkv=1))
    with pytest.raises(ValueError, match="dtype"):
        TMD.check_contract(q, pool(dtype=torch.float32),
                           pool(dtype=torch.float32))
    # quantized pools: int8/fp8 payloads with fp32 (P, Hkv) scales, q in
    # bf16 or fp32
    scales = torch.ones(4, 16)
    for payload in (torch.int8, torch.float8_e4m3fn):
        for qq in (q, q.float()):
            TMD.check_contract(qq, pool(dtype=payload), pool(dtype=payload),
                               scales, scales)
        with pytest.raises(ValueError, match="scales_k"):
            TMD.check_contract(q, pool(dtype=payload), pool(dtype=payload),
                               None, scales)
        with pytest.raises(ValueError, match="scales_v"):
            TMD.check_contract(q, pool(dtype=payload), pool(dtype=payload),
                               scales, torch.ones(4, 8))
    with pytest.raises(ValueError, match="scales_k"):
        TMD.check_contract(q, pool(dtype=torch.int8), pool(dtype=torch.int8),
                           scales.double(), scales)
    with pytest.raises(ValueError, match="one dtype"):
        TMD.check_contract(q, pool(dtype=torch.int8),
                           pool(dtype=torch.float8_e4m3fn), scales, scales)
    with pytest.raises(ValueError, match="int8/fp8"):
        TMD.check_contract(q, pool(dtype=torch.float16),
                           pool(dtype=torch.float16))
    with pytest.raises(ValueError, match="no scales"):
        TMD.check_contract(q, pool(), pool(), scales, scales)


def test_wrapper_device_dispatch():
    """CPU tensors take the plain version without touching the launch
    counter; other devices raise; unknown grids raise."""
    _, targs, _ = _both("g1")
    before = TMD.LAUNCHES
    TMD.moba_paged_decode(*targs)
    assert TMD.LAUNCHES == before
    meta = tuple(t.to("meta") if isinstance(t, torch.Tensor) else t
                 for t in targs)
    with pytest.raises(ValueError, match="meta"):
        TMD.moba_paged_decode(*meta)
    with pytest.raises(ValueError, match="grouped"):
        TMD.moba_paged_decode(*targs, grid="typo")
