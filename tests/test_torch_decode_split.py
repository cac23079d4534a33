"""The split decode path's plain arithmetic against the JAX reference.

The Hopper decode runs as three kernels (``csrc/moba_decode.cu``): a
route kernel that scores pages, keeps a running top-k over chunks of
pages and builds the GQA group's union tables; an attention kernel with
one CTA per (sequence, kv head, union slot, token chunk) writing
online-softmax partials; and a merge of those partials in slot order.
Their plain PyTorch versions (``kernels/moba_decode.py``:
``route_tables_plain``, ``decode_partials_plain``,
``merge_partials_plain``, ``plan``) are held here against the JAX
package on the same numpy inputs: the route against
``moba_paged_route`` + ``union_pages``, index-equal (tied centroids,
tables longer than the route's chunk, tables shorter than ``top_k``);
the partials and their merge against ``moba_paged_decode_pallas`` (both
grids, interpret mode) from fp32, int8 and fp8 pools, 1e-3
(``tests/test_backends.py``, ``tests/test_quantized_pages.py``).  The
kernels themselves run only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import moba as JM
from repro.kernels import moba_decode as JMD
from repro.kernels.centroids import block_centroids_kernel as j_centroids
from repro_torch.configs.base import MoBAConfig
from repro_torch.core import moba as TM
from repro_torch.core import quantization as TQ
from repro_torch.kernels import moba_decode as TMD
from repro_torch.kernels.centroids import block_centroids_kernel

from test_torch_decode import DISAGREE, GEOMETRIES, _case

ATOL = RTOL = 1e-3   # tests/test_backends.py:201, test_quantized_pages.py:43

PAGE16_K128 = dict(kv_lens=(8192, 5000, 40), top_k=128, h=4, hkv=2, d=16,
                   ps=16, npg=512, num_pages=1100)
ROUTE_GEOMETRIES = {
    **GEOMETRIES,
    "g4-disagree": DISAGREE,
    # npg 300 > the route's 128-page chunk, G = 2, top_k 6
    "long-table": dict(kv_lens=(4700, 17, 0, 2048), top_k=6, h=4, hkv=2,
                       d=16, ps=16, npg=300, num_pages=1000),
    # top_k 64 (the small-block regime's k) over three route chunks, G = 1
    "long-table-k64": dict(kv_lens=(4000, 3000, 16), top_k=64, h=2,
                           hkv=2, d=16, ps=16, npg=260, num_pages=800),
    # top_k 128 at page 16 over 512-page tables (8K tokens), G = 2: the
    # route's lists past the old 64-slot cap, four route chunks
    "page16-k128": PAGE16_K128,
}
# two 32-token chunks per 64-token page (fp32 pool at d 128)
MULTI_CHUNK = dict(kv_lens=(150, 64, 0, 97), top_k=2, h=4, hkv=2, d=128,
                   ps=64, npg=4, num_pages=24)
PARTIAL_GEOMETRIES = {**GEOMETRIES, "g4-disagree": DISAGREE,
                      "multi-chunk": MULTI_CHUNK}


def _jax_route(q, cache, table, kv_lens, geom):
    cfg = JMoBAConfig(block_size=geom["ps"], top_k=geom["top_k"])
    idx, val = JM.moba_paged_route(
        jnp.asarray(q), jnp.asarray(cache["centroids"]), jnp.asarray(table),
        jnp.asarray(kv_lens), cfg, page_size=geom["ps"])
    return idx, val


def _torch_route(q, cache, table, kv_lens, geom):
    return TMD.route_tables_plain(
        torch.from_numpy(q), torch.from_numpy(cache["centroids"]),
        torch.from_numpy(table), torch.from_numpy(kv_lens), geom["top_k"],
        geom["ps"])


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("geom", list(ROUTE_GEOMETRIES))
def test_route_tables_match_jax(geom, ties):
    """The route kernel's outputs, from its plain version: selections
    equal to JAX's route (slot order and validity), the union's pages,
    physical pages, per-head token bases and sizes equal to JAX's
    ``union_pages`` resolved through the block table."""
    g = ROUTE_GEOMETRIES[geom]
    q, cache, table, kv_lens = _case(g, tie_centroids=ties)
    got = _torch_route(q, cache, table, kv_lens, g)
    jidx, jval = _jax_route(q, cache, table, kv_lens, g)
    b, hkv, gg, _, k = jidx.shape
    want_sel = np.where(np.asarray(jval), np.asarray(jidx), -1)
    np.testing.assert_array_equal(got.sel.numpy(),
                                  want_sel.reshape(b * hkv, gg, k))
    npg, ps = table.shape[1], g["ps"]
    junion, jn = JMD.union_pages(jidx, jval, npg)
    np.testing.assert_array_equal(got.n_uniq.numpy(),
                                  np.asarray(jn).reshape(-1))
    union = np.asarray(junion).reshape(b * hkv, -1)
    rows_b = np.arange(b * hkv) // hkv
    phys = np.clip(np.maximum(table, 0)[rows_b[:, None], union], 0,
                   g["num_pages"] - 1)
    np.testing.assert_array_equal(got.phys.numpy(), phys)
    ids = want_sel.reshape(b * hkv, gg, k)
    live = np.arange(union.shape[1])[None] < got.n_uniq.numpy()[:, None]
    member = (ids[:, :, :, None] == union[:, None, None, :]).any(2)
    member &= live[:, None, :]
    base = np.where(member, union[:, None, :] * ps, npg * ps)
    np.testing.assert_array_equal(got.base.numpy(), base)
    # the kernel's tables are exactly decode_tables' on the same route
    tidx, tval = TM.moba_paged_route(
        torch.from_numpy(q), torch.from_numpy(cache["centroids"]),
        torch.from_numpy(table), torch.from_numpy(kv_lens),
        MoBAConfig(block_size=ps, top_k=g["top_k"]), page_size=ps)
    want = TMD.decode_tables(torch.from_numpy(q),
                             torch.from_numpy(cache["pages_k"]),
                             torch.from_numpy(table), tidx, tval)
    for a, w in zip((got.phys, got.base, got.n_uniq), want):
        assert torch.equal(a, w)


def test_route_chunks_and_short_tables_exercised():
    """The cases above reach what they are named for: a table longer than
    the route's chunk with a selection past it, and a table shorter than
    top_k padded with invalid slots."""
    g = ROUTE_GEOMETRIES["long-table"]
    q, cache, table, kv_lens = _case(g)
    sel = _torch_route(q, cache, table, kv_lens, g).sel
    assert table.shape[1] > TMD.ROUTE_CHUNK
    assert int(sel.max()) >= TMD.ROUTE_CHUNK
    g = GEOMETRIES["g2-short-table"]
    q, cache, table, kv_lens = _case(g)
    sel = _torch_route(q, cache, table, kv_lens, g).sel
    assert table.shape[1] < g["top_k"]
    assert bool((sel[:, :, table.shape[1]:] == -1).all())


# ------------------------------------------------------ partials and merge
def _quantized(cache, kv_dtype):
    """int8/fp8 payloads and (P, Hkv) scales of the fp32 pools, for both
    packages (the same bytes)."""
    t, j = {}, {}
    for name, sname in (("pages_k", "scales_k"), ("pages_v", "scales_v")):
        x = torch.from_numpy(cache[name])
        sc = TQ.compute_scale(x, (1, 3), kv_dtype)           # (P, Hkv)
        pay = TQ.quantize(x, sc[:, None, :, None], kv_dtype)
        t[name], t[sname] = pay, sc
        raw = jnp.asarray(pay.view(torch.uint8).numpy())
        j[name] = jax.lax.bitcast_convert_type(
            raw, jnp.int8 if kv_dtype == "int8" else jnp.float8_e4m3fn)
        j[sname] = jnp.asarray(sc.numpy())
    return t, j


def _partials_case(geom_name, kv_dtype):
    g = PARTIAL_GEOMETRIES[geom_name]
    q, cache, table, kv_lens = _case(g)
    if kv_dtype == "fp32":
        t = {k: torch.from_numpy(cache[k]) for k in ("pages_k", "pages_v")}
        j = {k: jnp.asarray(cache[k]) for k in ("pages_k", "pages_v")}
    else:
        t, j = _quantized(cache, kv_dtype)
    return g, q, cache, table, kv_lens, t, j


def _split_decode(g, q, cache, table, kv_lens, t, chunk=None):
    """route → partials → merge, as the three kernels compute them."""
    tq = torch.from_numpy(q)
    b, h, _, d = q.shape
    rt = _torch_route(q, cache, table, kv_lens, g)
    p = TMD.plan(b, h, g["hkv"], g["top_k"], table.shape[1], g["ps"], d,
                 t["pages_k"].element_size())
    if chunk is not None:             # any chunking gives the same output
        nc = -(-g["ps"] // chunk)
        p = p._replace(chunk=chunk, n_chunks=nc, slots=p.u_grid * nc)
    o, m, l = TMD.decode_partials_plain(
        tq, t["pages_k"], t["pages_v"], torch.from_numpy(kv_lens), rt, p,
        scales_k=t.get("scales_k"), scales_v=t.get("scales_v"))
    out = TMD.merge_partials_plain(o, m, l, rt.n_uniq, p, b, tq.dtype)
    return out, (o, m, l), rt, p


@pytest.mark.parametrize("grid", ["grouped", "flat"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("geom", list(PARTIAL_GEOMETRIES))
def test_partials_and_merge_match_jax_pallas(geom, kv_dtype, grid):
    """The split decode from the kernels' plain pieces against the TPU
    kernel in interpret mode; inactive rows give zeros."""
    g, q, cache, table, kv_lens, t, j = _partials_case(geom, kv_dtype)
    out, _, _, _ = _split_decode(g, q, cache, table, kv_lens, t)
    jsc = ({} if kv_dtype == "fp32" else
           dict(scales_k=j["scales_k"], scales_v=j["scales_v"]))
    want = np.asarray(JMD.moba_paged_decode_pallas(
        jnp.asarray(q), j["pages_k"], j["pages_v"],
        jnp.asarray(cache["centroids"]), jnp.asarray(table),
        jnp.asarray(kv_lens),
        JMoBAConfig(block_size=g["ps"], top_k=g["top_k"]), grid=grid,
        **jsc))
    active = kv_lens > 0
    np.testing.assert_allclose(out.numpy()[active], want[active], atol=ATOL,
                               rtol=RTOL)
    assert bool((out[torch.from_numpy(~active)] == 0).all())


def test_decode_page16_k128_matches_jax():
    """The split decode from the kernels' plain pieces (route tables,
    partials, merge) and the public wrapper's plain version at page 16,
    top_k 128, G 2, against the JAX package's XLA decode."""
    g = PAGE16_K128
    q, cache, table, kv_lens = _case(g)
    t = {k: torch.from_numpy(cache[k]) for k in ("pages_k", "pages_v")}
    out, _, rt, _ = _split_decode(g, q, cache, table, kv_lens, t)
    assert int((rt.sel >= 0).sum(-1).max()) == g["top_k"]
    cfg = MoBAConfig(block_size=g["ps"], top_k=g["top_k"])
    whole = TMD.moba_paged_decode(
        torch.from_numpy(q), t["pages_k"], t["pages_v"],
        torch.from_numpy(cache["centroids"]), torch.from_numpy(table),
        torch.from_numpy(kv_lens), cfg)
    want = np.asarray(JM.moba_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(cache["pages_k"]),
        jnp.asarray(cache["pages_v"]), jnp.asarray(cache["centroids"]),
        jnp.asarray(table), jnp.asarray(kv_lens),
        JMoBAConfig(block_size=g["ps"], top_k=g["top_k"])))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(whole.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_partials_independent_of_chunking(chunk):
    """Cutting a page into more token chunks (more CTAs, more partials)
    leaves the merged output equal to the plain decode."""
    g, q, cache, table, kv_lens, t, _ = _partials_case("multi-chunk", "int8")
    out, (o, m, l), rt, p = _split_decode(g, q, cache, table, kv_lens, t,
                                          chunk=chunk)
    assert o.shape == (p.rows, p.slots, p.g, q.shape[-1])
    want = TM.moba_paged_decode_attention(
        torch.from_numpy(q), t["pages_k"], t["pages_v"],
        torch.from_numpy(cache["centroids"]), torch.from_numpy(table),
        torch.from_numpy(kv_lens),
        MoBAConfig(block_size=g["ps"], top_k=g["top_k"]),
        scales_k=t["scales_k"], scales_v=t["scales_v"])
    active = torch.from_numpy(kv_lens > 0)
    torch.testing.assert_close(out[active], want[active], atol=1e-5,
                               rtol=1e-5)


def test_partials_of_disagreeing_heads():
    """G = 4 heads that pick different pages: a head that did not pick a
    union page holds the empty partial there (l = 0, m = -1e30, o = 0);
    slots past n_uniq and inactive rows hold only empty partials."""
    g, q, cache, table, kv_lens, t, _ = _partials_case("g4-disagree", "fp32")
    _, (o, m, l), rt, p = _split_decode(g, q, cache, table, kv_lens, t)
    slot = torch.arange(p.slots) // p.n_chunks
    live = slot[None] < rt.n_uniq[:, None]                  # (rows, S)
    empty = (l == 0) & (m == TM.NEG_INF) & (o == 0).all(-1)
    assert bool(empty[~live].all())
    assert bool((empty & live[..., None]).any())            # a head skipped
    assert bool((~empty & live[..., None]).any())


# ------------------------------------------------------------------- plan
PLAN_CASES = {
    # name: (b, h, hkv, top_k, npg, ps, d, itemsize) -> (chunk, n_chunks)
    "moba-340m-bf16": ((8, 16, 16, 8, 33, 128, 64, 2), (128, 1)),
    "moba-340m-int8": ((8, 16, 16, 8, 33, 128, 64, 1), (128, 1)),
    "fp32-d128-page256": ((2, 16, 8, 4, 40, 256, 128, 4), (32, 8)),
    "bf16-d128-page256": ((3, 24, 4, 8, 9, 256, 128, 2), (64, 4)),
    "g8-k64-short-table": ((1, 64, 8, 64, 20, 16, 64, 2), (16, 1)),
    "g8-k512-page16": ((1, 64, 8, 512, 512, 16, 64, 2), (16, 1)),
    "fp8-d128-page48": ((5, 4, 4, 2, 7, 48, 128, 1), (48, 1)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan(case):
    """The wrapper's grids and scratch as plain Python: chunks cover the
    page, the attention grid stops at min(G·top_k, npg) union slots, and
    every live (row, union slot, chunk) partial lies inside the
    scratch for any n_uniq the route can give."""
    (b, h, hkv, k, npg, ps, d, itemsize), (chunk, nc) = PLAN_CASES[case]
    p = TMD.plan(b, h, hkv, k, npg, ps, d, itemsize)
    g = h // hkv
    assert (p.chunk, p.n_chunks) == (chunk, nc)
    assert p.chunk * d * itemsize <= 16384 and p.chunk % 16 == 0
    assert p.n_chunks * p.chunk >= ps > (p.n_chunks - 1) * p.chunk
    assert p.rows == b * hkv and p.g == g and p.u_cap == g * k
    assert p.u_grid == min(g * k, npg) and p.slots == p.u_grid * nc
    assert p.int_sizes == (p.rows * g * k, p.rows * g * k,
                           p.rows * g * g * k, p.rows)
    assert p.float_sizes == (p.rows * p.slots * g * d, p.rows * p.slots * g
                             * 2)
    rng = np.random.default_rng(0)
    n_uniq = rng.integers(0, p.u_grid + 1, p.rows)
    live = [(r, u * nc + c) for r in range(p.rows)
            for u in range(int(n_uniq[r])) for c in range(nc)]
    assert all(x < p.slots for _, x in live)
    assert len(live) == int(n_uniq.sum()) * nc <= p.rows * p.slots


def test_contract_routing_inputs():
    """Shaped errors for routing inputs the kernels do not take, before
    any launch: top_k past the route's running list, a block table that
    is not int32, kv_len of another dtype, centroids not fp32."""
    q = torch.zeros(2, 16, 1, 64, dtype=torch.bfloat16)
    pool = torch.zeros(4, 128, 16, 64, dtype=torch.bfloat16)
    cents = torch.zeros(4, 16, 64)
    table = torch.zeros(2, 3, dtype=torch.int32)
    kv = torch.zeros(2, dtype=torch.int32)
    ok = dict(centroids=cents, block_table=table, kv_len=kv, top_k=8)
    TMD.check_contract(q, pool, pool, **ok)
    TMD.check_contract(q, pool, pool, **{**ok, "kv_len": kv.long(),
                                         "top_k": TMD.MAX_TOP_K})
    for bad, match in ((dict(top_k=TMD.MAX_TOP_K + 1), "top_k"),
                       (dict(block_table=table.long()), "block table"),
                       (dict(block_table=table[:, :0]), "block table"),
                       (dict(kv_len=kv.float()), "kv_len"),
                       (dict(kv_len=kv[:1]), "kv_len"),
                       (dict(centroids=cents.double()), "centroids")):
        with pytest.raises(ValueError, match=match):
            TMD.check_contract(q, pool, pool, **{**ok, **bad})


def test_contract_names_the_route_limit():
    """top_k up to 512 at G 8 passes; past it the shaped error names the
    limit the route kernel's shared memory sets."""
    q = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
    pool = torch.zeros(4, 16, 8, 64, dtype=torch.bfloat16)
    assert TMD.MAX_TOP_K == 512
    TMD.check_contract(q, pool, pool, top_k=512)
    with pytest.raises(ValueError, match="top_k in 1..512, the limit the "
                                         "route kernel's shared memory"):
        TMD.check_contract(q, pool, pool, top_k=513)


ROUTE_SMEM_CASES = {
    # name: (g, top_k, npg, d) -> (static, dynamic) bytes
    "moba-340m": ((1, 8, 33, 64), (6144, 224)),
    "g8-k200-page16-d128": ((8, 200, 512, 128), (8192, 44800)),
    "g8-k512-short-table": ((8, 512, 100, 64), (6144, 22400)),
    "g8-k512-page16-d128": ((8, 512, 512, 128), (8192, 114688)),
}


@pytest.mark.parametrize("case", list(ROUTE_SMEM_CASES))
def test_route_smem_bytes(case):
    """The route CTA's shared memory: lists sized from G·min(top_k, npg);
    at G 8 / top_k 200 / d 128 the dynamic part alone is under 48 KB but
    static plus dynamic is over it (the launch must ask for it), and the
    limit's geometry fits the card's 227 KB a block."""
    args, want = ROUTE_SMEM_CASES[case]
    static, dynamic = TMD.route_smem_bytes(*args)
    assert (static, dynamic) == want
    assert static + dynamic <= 227 * 1024
    if case == "g8-k200-page16-d128":
        assert dynamic < 48 * 1024 < static + dynamic


def test_cpu_call_counts_no_launch():
    """A CPU call runs the plain version and counts no call or kernel."""
    g = GEOMETRIES["g1"]
    q, cache, table, kv_lens = _case(g)
    before = (TMD.LAUNCHES, TMD.KERNEL_LAUNCHES)
    TMD.moba_paged_decode(
        torch.from_numpy(q), torch.from_numpy(cache["pages_k"]),
        torch.from_numpy(cache["pages_v"]),
        torch.from_numpy(cache["centroids"]), torch.from_numpy(table),
        torch.from_numpy(kv_lens), MoBAConfig(block_size=16, top_k=3))
    assert (TMD.LAUNCHES, TMD.KERNEL_LAUNCHES) == before


# -------------------------------------------------------------- centroids
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_centroids_ragged_both_head_dims(d, dtype):
    """The head dims the 16-byte kernel takes, with a ragged tail block
    (200 keys in blocks of 64: a tail of 8), against the TPU kernel."""
    k = np.random.default_rng(3).normal(size=(3, 200, d)).astype(np.float32)
    got = block_centroids_kernel(torch.from_numpy(k).to(getattr(torch,
                                                                dtype)), 64)
    want = j_centroids(jnp.asarray(k, dtype), 64)
    assert got.shape == (3, 4, d) and got.dtype == getattr(torch, dtype)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
