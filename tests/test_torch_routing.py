"""Top-k order on signed zeros: the port against ``jax.lax.top_k``.

``lax.top_k`` orders scores on the float's total order (+0.0 above -0.0),
then by the lower index.  The port defines that order once
(``core/routing.py::order_key``) and uses it in ``topk_desc`` (and so in
``select_blocks`` and ``flash_topk_ref``), in the decode route kernel's
plain version (``route_tables_plain``) and in Flash TopK's plain merge
(``flash_topk_merge_ref``).  Dot products yield +0.0 for a zero centroid
on both sides, so these tests hand the scores in directly: exact ±0.0
ties, ±0.0 mixed with equal nonzero scores, and rounded normals (whose
small negatives round to -0.0), each compared with ``lax.top_k`` on the
same numpy scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import routing as JR
from repro_torch.core import routing as TR
from repro_torch.kernels import moba_decode as TMD
from repro_torch.kernels import ref as TREF
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KINDS = ("zeros", "zeros-and-equal", "rounded")


def _scores(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        pool = np.array([-0.0, 0.0], np.float32)
    elif kind == "zeros-and-equal":
        pool = np.array([-0.0, 0.0, 1.0, -1.0, 0.5, -0.5], np.float32)
    else:
        return np.round(rng.standard_normal(shape)).astype(np.float32)
    return rng.choice(pool, size=shape)


def _lax_top_k(scores: np.ndarray, k: int):
    vals, idx = jax.lax.top_k(jnp.asarray(scores), k)
    return np.asarray(vals), np.asarray(idx)


def test_order_key_is_the_float_total_order():
    x = np.array([-np.inf, -1e30, -1.0, -1e-38, -0.0, 0.0, 1e-38, 1.0,
                  1e30, np.inf], np.float32)
    key = TR.order_key(torch.from_numpy(x)).numpy()
    assert (np.diff(key.astype(np.int64)) > 0).all()
    assert TR.order_key(torch.tensor([0.0])) == 0


@pytest.mark.parametrize("k", [1, 4, 13])
@pytest.mark.parametrize("kind", KINDS)
def test_topk_desc_orders_signed_zeros_as_lax(kind, k):
    scores = _scores(kind, (3, 5, 13), seed=k)
    assert np.signbit(scores).any() and (scores == 0).any()
    vals, idx = TR.topk_desc(torch.from_numpy(scores), k)
    want_vals, want_idx = _lax_top_k(scores, k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(np.signbit(vals.numpy()),
                                  np.signbit(want_vals))


@pytest.mark.parametrize("kind", KINDS)
def test_select_blocks_signed_zero_ties_equal_jax(kind):
    """Causal selection (own block forced, future blocks masked) on
    signed-zero ties, against the reference's ``select_blocks``."""
    nq, nb, bs, top_k = 24, 8, 4, 4
    scores = _scores(kind, (2, 3, nq, nb), seed=7)
    pos = np.arange(nq) + 2 * bs
    got = TR.select_blocks(torch.from_numpy(scores), top_k, bs,
                           torch.from_numpy(pos))
    want = JR.select_blocks(jnp.asarray(scores), top_k, bs,
                            jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_decode_route_plain_orders_signed_zeros_as_lax(kind, monkeypatch):
    """``route_tables_plain``'s running top-k over 128-page chunks (here
    two: 165 pages) selects what ``lax.top_k`` selects from the same
    masked scores."""
    b, hkv, g, d, ps, top_k = 2, 2, 3, 8, 16, 8
    npg = TMD.ROUTE_CHUNK + 37
    scores = _scores(kind, (b, hkv, g, 1, npg), seed=11)
    monkeypatch.setattr(TMD, "paged_route_scores",
                        lambda *a, **kw: torch.from_numpy(scores))
    q = torch.zeros(b, hkv * g, 1, d)
    centroids = torch.zeros(b * npg, hkv, d)
    table = torch.arange(b * npg, dtype=torch.int32).reshape(b, npg)
    kv_len = torch.full((b,), npg * ps, dtype=torch.int32)
    tables = TMD.route_tables_plain(q, centroids, table, kv_len, top_k, ps)
    _, want = _lax_top_k(scores[..., 0, :], top_k)
    np.testing.assert_array_equal(tables.sel.numpy(),
                                  want.reshape(b * hkv, g, top_k))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("kind", KINDS)
def test_flash_topk_merge_ref_orders_signed_zeros_as_lax(kind, causal,
                                                         monkeypatch):
    """Flash TopK's plain merge, candidate by candidate, against
    ``lax.top_k`` (non-causal) and the reference's ``select_blocks``
    (causal) on the same scores; ``flash_topk_ref`` agrees with both."""
    bh, nq, nb, d, bs, top_k = 4, 20, 9, 8, 4, 5
    scores = _scores(kind, (bh, nq, nb), seed=3)
    monkeypatch.setattr(TR, "routing_scores",
                        lambda q, c: torch.from_numpy(scores))
    q = torch.zeros(bh, nq, d)
    cents = torch.zeros(bh, nb, d)
    kw = dict(causal=causal, q_pos_offset=2 * bs)
    got = TREF.flash_topk_merge_ref(q, cents, top_k, bs, **kw)
    if causal:
        want = np.asarray(JR.select_blocks(
            jnp.asarray(scores), top_k, bs, jnp.arange(nq) + 2 * bs))
    else:
        want = _lax_top_k(scores, top_k)[1]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TREF.flash_topk_ref(q, cents, top_k, bs, **kw).numpy(), want)
