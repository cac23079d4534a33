"""The port's FlashMoBA training path against the JAX package, kernel by
kernel and as a whole, on the same numpy-made inputs.

On CPU tensors every kernel wrapper of the port takes its plain version
(``repro_torch/kernels/ref.py``); the JAX side runs its Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` does.  Selections and
layouts must be bit-equal; partials and outputs match at the fp32 2e-4
of ``tests/test_kernels.py:24`` (bf16 3e-2), gradients at 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import moba as JM
from repro.core import routing as JR
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.centroids import block_centroids_kernel as j_centroids
from repro.kernels.flash_topk import flash_topk as j_flash_topk
from repro.kernels.moba_bwd import moba_bwd as j_moba_bwd
from repro.kernels.moba_fwd import moba_fwd as j_moba_fwd
from repro_torch.configs.base import MoBAConfig
from repro_torch.core import moba as TM
from repro_torch.core import routing as TR
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.centroids import block_centroids_kernel
from repro_torch.kernels.flash_topk import flash_topk
from repro_torch.kernels import flash_topk as TK
from repro_torch.kernels import moba_bwd as TB
from repro_torch.kernels import moba_fwd as TF
from repro_torch.kernels.moba_bwd import moba_bwd, segments
from repro_torch.kernels.moba_fwd import moba_fwd

F32 = dict(atol=2e-4, rtol=2e-4)         # tests/test_kernels.py:24 (fp32)
BF16 = dict(atol=3e-2, rtol=3e-2)
GRAD = dict(atol=5e-3, rtol=5e-3)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(seed, b=1, h=4, hkv=2, n=128, d=16, nq=None, scale=0.5):
    rng = np.random.default_rng(seed)
    nq = nq or n
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32) * scale
    k = rng.normal(size=(b, hkv, n, d)).astype(np.float32) * scale
    v = rng.normal(size=(b, hkv, n, d)).astype(np.float32)
    return q, k, v


# ---------------------------------------------------------------- centroids
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_centroids_match_jax(dtype):
    """A ragged tail block (70 keys, blocks of 16) in both dtypes."""
    k = np.random.default_rng(0).normal(size=(4, 70, 32)).astype(np.float32)
    got = block_centroids_kernel(_t(k).to(getattr(torch, dtype)), 16)
    want = j_centroids(jnp.asarray(k, dtype), 16)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------- flash topk
TOPK_CASES = {
    # name: (h, hkv, n, nq, bs, top_k, q_tile, cent_tile, causal)
    "g1-causal": (2, 2, 128, 128, 16, 3, 32, 128, True),
    "g2-causal": (4, 2, 128, 128, 16, 4, 64, 128, True),
    "g2-bidirectional": (4, 2, 128, 128, 16, 3, 64, 128, False),
    "cent-tile-ragged": (4, 2, 144, 144, 16, 4, 48, 8, True),
    "nb-below-top-k": (4, 2, 48, 48, 16, 5, 16, 128, True),
    "query-suffix": (4, 2, 128, 64, 16, 3, 32, 128, True),
    "tied-centroids": (4, 2, 128, 128, 16, 3, 64, 128, True),
    # the small-block regime: top_k 32 over 64 blocks of 16
    "k32-block16": (2, 2, 1024, 1024, 16, 32, 128, 128, True),
    "k64-g2": (4, 2, 1024, 1024, 16, 64, 128, 128, True),
    "k32-above-nb": (4, 2, 256, 256, 16, 32, 64, 128, True),
    "tied-centroids-k32": (4, 2, 1024, 1024, 16, 32, 128, 128, True),
}


@pytest.mark.parametrize("grid", ["grouped", "flat"])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_flash_topk_bit_equal_to_jax(case, grid):
    h, hkv, n, nq, bs, tk, qt, ct, causal = TOPK_CASES[case]
    q, k, _ = _qkv(len(case) + tk, h=h, hkv=hkv, n=n, nq=nq)
    if case.startswith("tied-centroids"):
        k[:] = k[:, :, :1]                    # every block scores the same
    cents = np.asarray(JR.block_centroids(jnp.asarray(k), bs)).reshape(
        hkv, -1, 16)
    qf = q.reshape(h, nq, 16)
    kw = dict(group=h // hkv, num_q_heads=h, causal=causal,
              q_pos_offset=n - nq, q_tile=qt, cent_tile=ct, grid=grid)
    got = flash_topk(_t(qf), _t(cents), tk, bs, **kw)
    want = j_flash_topk(jnp.asarray(qf), jnp.asarray(cents), tk, bs, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


MERGE_CASES = {
    # name: (h, hkv, nq, nb, bs, top_k, causal, q_pos_offset)
    "k8-causal": (2, 2, 256, 16, 16, 8, True, 0),
    "k32-g2": (4, 2, 512, 32, 16, 32, True, 0),
    "k64-above-nb": (2, 1, 128, 16, 8, 64, True, 0),
    "k5-suffix": (4, 2, 64, 12, 16, 5, True, 128),
    "k12-bidirectional": (2, 2, 64, 20, 16, 12, False, 256),
}


@pytest.mark.parametrize("case", MERGE_CASES)
def test_flash_topk_merge_mirror_bit_equal_to_jax(case):
    """The CUDA kernel's filter-and-rank merge (``flash_topk_merge_ref``,
    candidates in the kernel's order) against the Pallas kernel on
    integer-valued scores with many exact ties: the tie order is
    lax.top_k's."""
    h, hkv, nq, nb, bs, tk, causal, off = MERGE_CASES[case]
    rng = np.random.default_rng(nb + tk)
    q = rng.integers(-1, 2, size=(h, nq, 16)).astype(np.float32)
    cents = rng.integers(-1, 2, size=(hkv, nb, 16)).astype(np.float32)
    kw = dict(group=h // hkv, num_q_heads=h, causal=causal,
              q_pos_offset=off)
    got = TREF.flash_topk_merge_ref(_t(q), _t(cents), tk, bs, **kw)
    want = np.asarray(j_flash_topk(jnp.asarray(q), jnp.asarray(cents), tk,
                                   bs, q_tile=min(64, nq), **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    scores = np.einsum("hqd,hbd->hqb", q, np.repeat(cents, h // hkv, 0))
    assert (scores == np.round(scores)).all()
    # many ties: most rows hold a score shared by two of their blocks
    srt = np.sort(scores, -1)
    assert (srt[..., 1:] == srt[..., :-1]).any(-1).mean() > 0.5


@pytest.mark.parametrize("top_k", [1, 8, 16, 17, 32, 33, 64, 128, 129, 256,
                                   512, 1000, 1024])
def test_flash_topk_contract_accepts_top_k(top_k):
    """Every top_k up to the limit, at d 64 and 128, G 1 and 8, in bf16
    and fp32 (shape-only operands)."""
    for d in (64, 128):
        for g in (1, 8):
            for dt in (torch.bfloat16, torch.float32):
                q = torch.zeros((), dtype=dt).expand(2 * g, 8192, d)
                cents = torch.zeros((), dtype=dt).expand(2, 512, d)
                TK.check_contract(q, cents, top_k, g, 2 * g, 0)


@pytest.mark.parametrize("top_k,rows", [(1, 128), (32, 128), (33, 128),
                                        (128, 128), (129, 112), (256, 64),
                                        (512, 32), (1024, 16)])
def test_flash_topk_rows_per_cta(top_k, rows):
    """Rows a CTA covers: 128 with register lists (top_k <= 32) and while
    the shared-memory lists fit, then 16·floor(1024 / top_k)."""
    assert TK.rows_per_cta(top_k) == rows


def test_flash_topk_contract_names_its_limits():
    """Past the limit the shaped error names it: top_k 1025, and a GQA
    group wider than the rows a CTA covers at that top_k."""
    q = torch.zeros(32, 64, 64, dtype=torch.bfloat16)
    cents = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    assert TK.MAX_TOP_K == 1024
    with pytest.raises(ValueError, match="top_k in 1..1024, the limit"):
        TK.check_contract(q[:1], cents, 1025, 1, 1, 0)
    with pytest.raises(ValueError, match="group of at most 16 heads at "
                                         "top_k 1024"):
        TK.check_contract(q, cents, 1024, 32, 32, 0)
    TK.check_contract(q, cents, 128, 32, 32, 0)


def test_flash_topk_rejects_unknown_grid():
    q = torch.zeros(2, 32, 16)
    with pytest.raises(ValueError, match="grouped"):
        flash_topk(q, torch.zeros(2, 2, 16), 2, 16, grid="typo")


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("tile", [8, 32])
def test_build_varlen_layout_index_equal_to_jax(tile):
    """Random selections with sentinels (nb) and repeated blocks."""
    rng = np.random.default_rng(tile)
    nq, k, nb = 64, 3, 6
    sel = rng.integers(0, nb + 1, size=(3, nq, k)).astype(np.int32)
    got = TR.build_varlen_layout(_t(sel), nq, nb, tile)
    want = jax.vmap(lambda s: JR.build_varlen_layout(s, nq, nb, tile))(
        jnp.asarray(sel))
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.q_index.shape[1] == TR.layout_capacity(nq, k, nb, tile)


# ------------------------------------------------- forward / backward kernels
def _layout_case(seed, h=4, hkv=2, n=120, d=16, bs=16, tk=3, tile=32):
    """A ragged-N routed layout built by JAX, as both kernels see it,
    with one block no query selects."""
    q, k, v = _qkv(seed, h=h, hkv=hkv, n=n, d=d)
    cfg = JMoBAConfig(block_size=bs, top_k=tk)
    nb = -(-n // bs)
    sel = JM.moba_selection(jnp.asarray(q), jnp.asarray(k), cfg).reshape(
        h, n, tk)
    # no query keeps block 2, so the layout has an unvisited block
    sel = jnp.where(sel == 2, nb, sel)
    # n = 120 is no multiple of the tile: pad queries route to nb
    n_p = -(-n // tile) * tile
    sel = jnp.concatenate([sel, jnp.full((h, n_p - n, tk), nb, jnp.int32)],
                          axis=1)
    lay = jax.vmap(lambda s: JR.build_varlen_layout(s, n_p, nb, tile))(sel)
    qf = np.concatenate([q.reshape(h, n, d),
                         np.zeros((h, n_p - n, d), np.float32)], axis=1)
    qi = np.maximum(np.asarray(lay.q_index), 0)
    q_sorted = np.take_along_axis(qf, qi[..., None], axis=1)
    q_pos = np.where(np.asarray(lay.q_index) >= 0, qi, -1).astype(np.int32)
    kb = np.concatenate([k, np.zeros((1, hkv, nb * bs - n, d), np.float32)],
                        axis=2).reshape(hkv, nb, bs, d)
    vb = np.concatenate([v, np.zeros((1, hkv, nb * bs - n, d), np.float32)],
                        axis=2).reshape(hkv, nb, bs, d)
    kw = dict(scale=d ** -0.5, block_size=bs, n_tokens=n, num_q_heads=h,
              group=h // hkv, q_tile=tile)
    return np.asarray(lay.tile_block), q_sorted, q_pos, kb, vb, kw


@pytest.mark.parametrize("grid", ["grouped", "flat"])
def test_moba_fwd_partials_match_jax(grid):
    tb, qs, qp, kb, vb, kw = _layout_case(5)
    got = moba_fwd(*map(_t, (tb, qs, qp, kb, vb)), grid=grid, **kw)
    want = j_moba_fwd(*map(jnp.asarray, (tb, qs, qp, kb, vb)), grid=grid,
                      **kw)
    for name, g, w in zip("oml", got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), err_msg=name, **F32)


@pytest.mark.parametrize("grid", ["grouped", "flat"])
def test_moba_bwd_matches_jax_on_visited_blocks(grid):
    tb, qs, qp, kb, vb, kw = _layout_case(6)
    rng = np.random.default_rng(6)
    do = rng.normal(size=qs.shape).astype(np.float32)
    lse = (rng.normal(size=qp.shape) + 2.0).astype(np.float32)
    delta = rng.normal(size=qp.shape).astype(np.float32) * 0.1
    args = (tb, qs, qp, do, lse, delta, kb, vb)
    got = moba_bwd(*map(_t, args), grid=grid, **kw)
    want = j_moba_bwd(*map(jnp.asarray, args), grid=grid, **kw)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), **F32)
    nb = kb.shape[1]
    visited = np.zeros((tb.shape[0], nb + 1), bool)
    np.put_along_axis(visited, tb.astype(np.int64), True, axis=1)
    visited = visited[:, :nb]
    assert visited.any() and not visited.all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy()[visited], _np(w)[visited],
                                   **F32)
        assert not g.numpy()[~visited].any()   # the port's are zero


@pytest.mark.parametrize("run_tiles", [1, 3, TB.RUN_TILES])
def test_moba_bwd_segments_cover_each_run(run_tiles):
    """The backward kernel's launch tables: every active tile belongs to
    exactly one segment of its own block, a segment holds at most
    ``run_tiles`` tiles, each block's segments are consecutive, spare
    CTAs are marked -1 and the inactive tail starts after the last active
    tile."""
    rng = np.random.default_rng(run_tiles)
    nq, k, nb, tile = 64, 3, 6, 8
    sel = rng.integers(0, nb + 1, size=(3, nq, k)).astype(np.int32)
    sel[0][sel[0] == 2] = nb                       # an unvisited block
    tb = TR.build_varlen_layout(_t(sel), nq, nb, tile).tile_block
    seg_block, lo, hi, tail_lo, first, count = (
        t.numpy() for t in segments(tb, nb, run_tiles))
    assert count[0, 2] == 0
    for r in range(3):
        owner = np.full(tb.shape[1], -1)
        for s in np.flatnonzero(seg_block[r] >= 0):
            j = seg_block[r, s]
            assert 0 < hi[r, s] - lo[r, s] <= run_tiles
            assert first[r, j] <= s < first[r, j] + count[r, j]
            assert (owner[lo[r, s]:hi[r, s]] == -1).all()
            owner[lo[r, s]:hi[r, s]] = j
        assert (seg_block[r, count[r].sum():] == -1).all()
        active = tb[r].numpy() < nb
        np.testing.assert_array_equal(owner[active], tb[r].numpy()[active])
        assert (owner[~active] == -1).all()
        assert tail_lo[r] == active.sum()


def test_moba_bwd_plain_takes_bf16_do_as_its_fp32_upcast():
    """The bf16 kernel takes dO in bf16; the plain version upcasts it, so
    a bf16 dO and its fp32 upcast give bit-equal gradients."""
    tb, qs, qp, kb, vb, kw = _layout_case(7)
    rng = np.random.default_rng(7)
    do = _t(rng.normal(size=qs.shape).astype(np.float32)).bfloat16()
    lse = _t((rng.normal(size=qp.shape) + 2.0).astype(np.float32))
    delta = _t(rng.normal(size=qp.shape).astype(np.float32) * 0.1)
    args = [_t(x).bfloat16() if x.dtype == np.float32 else _t(x)
            for x in (tb, qs, qp)]
    blocks = [_t(x).bfloat16() for x in (kb, vb)]
    got = moba_bwd(*args, do, lse, delta, *blocks, **kw)
    want = moba_bwd(*args, do.float(), lse, delta, *blocks, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------- the CUDA kernels' contracts
def _contract_operands(nq, bs, d, g, dtype, do_dtype=None, top_k=8):
    """Shape-only operands (expanded scalars: no memory) of the forward
    and backward kernels exactly as ``flash_moba`` hands them over for
    H = 4 query heads on 4 / G kv heads, N = max(Nq, bs) keys and the
    default q tile."""
    h, n = 4, max(nq, bs)
    tile = min(128, nq)
    nb = -(-n // bs)
    nq_p = -(-nq // tile) * tile
    ln = TR.layout_capacity(nq_p, min(top_k, nb), nb, tile)

    def t(shape, dt):
        return torch.zeros((), dtype=dt).expand(shape)

    q_sorted = t((h, ln, d), dtype)
    return dict(tile_block=t((h, ln // tile), torch.int32),
                q_sorted=q_sorted, q_pos=t((h, ln), torch.int32),
                k_blocks=t((h // g, nb, bs, d), dtype),
                v_blocks=t((h // g, nb, bs, d), dtype),
                do_sorted=t((h, ln, d), do_dtype or dtype),
                lse=t((h, ln), torch.float32), tile=tile, h=h, g=g,
                kb_tile=TF.resolve_kb_tile(0, bs))


def _check_fwd(o):
    TF.check_contract(o["tile_block"], o["q_sorted"], o["q_pos"],
                      o["k_blocks"], o["v_blocks"], o["tile"], o["kb_tile"],
                      o["h"], o["g"])


def _check_bwd(o):
    TB.check_contract(o["q_sorted"], o["do_sorted"], o["lse"], o["lse"],
                      o["k_blocks"], o["v_blocks"], o["tile_block"],
                      o["q_pos"], o["tile"], o["h"], o["g"])


@pytest.mark.parametrize("d,g", [(64, 1), (64, 2), (128, 1), (128, 2)])
@pytest.mark.parametrize("bs", [16, 32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("nq", [1, 37, 128, 1000, 8000])
def test_kernel_contracts_accept_flash_moba_shapes(nq, bs, d, g):
    """Every (q tile, block, kb_tile, d, G) that ``flash_moba`` produces
    for the repo's configs and benchmarks passes both CUDA kernels'
    contracts, in bf16 (dO in bf16) and fp32."""
    for dtype in (torch.bfloat16, torch.float32):
        o = _contract_operands(nq, bs, d, g, dtype)
        _check_fwd(o)
        _check_bwd(o)


FWD_REJECTS = {
    # name: (operand overrides, message fragment)
    "bf16-block-24": (dict(bs=24), "multiple of 16"),
    "head-dim-96": (dict(d=96), "head_dim"),
    "fp16": (dict(dtype=torch.float16), "one dtype"),
}
BWD_REJECTS = {
    "fp32-do-with-bf16-q": (dict(do_dtype=torch.float32), "one dtype"),
    "bf16-block-24": (dict(bs=24), "multiple of 16 keys"),
    "head-dim-96": (dict(d=96), "head_dim"),
    "fp16": (dict(dtype=torch.float16), "one dtype"),
}


@pytest.mark.parametrize("case", FWD_REJECTS)
def test_moba_fwd_contract_rejects(case):
    over, frag = FWD_REJECTS[case]
    kw = dict(nq=256, bs=128, d=64, g=1, dtype=torch.bfloat16)
    kw.update(over)
    with pytest.raises(ValueError, match=f"moba_fwd CUDA kernel needs.*"
                                         f"{frag}"):
        _check_fwd(_contract_operands(**kw))


@pytest.mark.parametrize("case", BWD_REJECTS)
def test_moba_bwd_contract_rejects(case):
    over, frag = BWD_REJECTS[case]
    kw = dict(nq=256, bs=128, d=64, g=1, dtype=torch.bfloat16)
    kw.update(over)
    with pytest.raises(ValueError, match=f"moba_bwd CUDA kernel needs.*"
                                         f"{frag}"):
        _check_bwd(_contract_operands(**kw))


def test_moba_fwd_contract_rejects_long_q_tile_and_odd_kb_tile():
    o = _contract_operands(256, 128, 64, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="q tile of 1..128"):
        TF.check_contract(o["tile_block"][:, :1], o["q_sorted"][:, :256],
                          o["q_pos"], o["k_blocks"], o["v_blocks"], 256, 128,
                          4, 1)
    with pytest.raises(ValueError, match="kb_tile a multiple of 16"):
        TF.check_contract(o["tile_block"], o["q_sorted"], o["q_pos"],
                          o["k_blocks"], o["v_blocks"], o["tile"], 24, 4, 1)


def test_moba_bwd_contract_rejects_bf16_lse():
    o = _contract_operands(256, 128, 64, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 lse and delta"):
        TB.check_contract(o["q_sorted"], o["do_sorted"],
                          o["lse"].bfloat16(), o["lse"], o["k_blocks"],
                          o["v_blocks"], o["tile_block"], o["q_pos"],
                          o["tile"], 4, 1)


@pytest.mark.parametrize("bs,dtype,want", [
    (16, torch.bfloat16, 1), (128, torch.bfloat16, 1),
    (144, torch.bfloat16, 2), (256, torch.bfloat16, 2),
    (256, torch.float32, 1), (512, torch.float32, 1),
    (512, torch.bfloat16, 4), (1024, torch.bfloat16, 8)])
def test_moba_bwd_dq_partials(bs, dtype, want):
    """The bf16 backward holds SPLIT_KEYS keys a CTA, so a longer block
    writes one dQ partial per 128 keys; the SIMT fp32 body writes one."""
    assert TB.dq_partials(bs, dtype) == want


# --------------------------------------------------------- flash_moba whole
FLASH_CASES = {
    # name: (h, hkv, n, d, bs, top_k, q_tile, dtype)
    "fp32-gqa": (4, 2, 128, 32, 16, 3, 64, "float32"),
    "fp32-odd-nq": (2, 2, 100, 32, 16, 3, 64, "float32"),
    "bf16-gqa": (4, 1, 128, 16, 16, 4, 64, "bfloat16"),
    # the paper's small blocks, and original MoBA's 512-key blocks
    "fp32-block16-k32": (2, 2, 1024, 16, 16, 32, 128, "float32"),
    "bf16-block512-k2": (2, 1, 1024, 16, 512, 2, 128, "bfloat16"),
}


def _grads(fn, q, k, v):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    (out.float() ** 2).sum().backward()
    return out.detach(), [x.grad for x in (q, k, v)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_moba_matches_jax_and_reference(case):
    h, hkv, n, d, bs, tk, qt, dtype = FLASH_CASES[case]
    q, k, v = _qkv(n + h * tk, h=h, hkv=hkv, n=n, d=d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    tq, tk_, tv = (_t(x).to(tdt) for x in (q, k, v))
    jcfg, tcfg = JMoBAConfig(bs, tk), MoBAConfig(bs, tk)
    tol = BF16 if dtype == "bfloat16" else F32
    gtol = BF16 if dtype == "bfloat16" else GRAD

    out, grads = _grads(lambda a, b, c: TOPS.flash_moba(a, b, c, tcfg,
                                                        q_tile=qt),
                        tq, tk_, tv)
    ref = TM.moba_attention_reference(tq, tk_, tv, tcfg)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               **tol)

    def loss(a, b, c):
        o = JOPS.flash_moba(a, b, c, jcfg, q_tile=qt)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    want = JOPS.flash_moba(jq, jk, jv, jcfg, q_tile=qt)
    np.testing.assert_allclose(out.float().numpy(), _np(want), **tol)
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
    for g, w in zip(grads, jgrads):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), _np(w), **gtol)


def test_moba_sparse_xla_matches_jax():
    """Forward and grads of the ``xla`` backend's path, GQA."""
    q, k, v = _qkv(31, h=4, hkv=2, n=128, d=16)
    jcfg, tcfg = JMoBAConfig(16, 4), MoBAConfig(16, 4)
    out, grads = _grads(lambda a, b, c: TREF.moba_sparse_xla(a, b, c, tcfg,
                                                             tile=32),
                        *map(_t, (q, k, v)))

    def loss(a, b, c):
        return jnp.sum(JREF.moba_sparse_xla(a, b, c, jcfg, tile=32) ** 2)

    want = JREF.moba_sparse_xla(*map(jnp.asarray, (q, k, v)), jcfg, tile=32)
    np.testing.assert_allclose(out.numpy(), _np(want), **F32)
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), _np(w), **GRAD)
