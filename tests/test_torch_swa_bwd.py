"""The SWA layers' training attention of the PyTorch port (``kernels/
swa.py::SWAAttention``) against ``jax.grad`` of the JAX package's
windowed dense attention, on the same numpy inputs and the geometries of
``tests/test_torch_swa.py`` plus GQA at head_dim 128.

The CUDA kernels run only on the card (``chip_smoke.py``'s ``swa``
phase).  Here: a mirror of the backward kernel's two passes
(``csrc/swa_bwd.cu``: the query-major pass's chunk walk, ``swa.
band_chunks``, with delta; the key-major pass's walk of query rows, ``swa.
band_slices``; fp32 products of bf16 inputs and the bf16 roundings the
kernel makes) held against ``jax.grad``; the key-major walk against every
key's band; the log-sum-exp the forward writes (its body's mirror) against
the plain one; the plain backward; and which inputs the flash backend
sends to the Function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention import dense_attention as jax_dense
from repro_torch.configs.base import AttentionConfig
from repro_torch.core import backends as B
from repro_torch.core.attention import dense_attention
from repro_torch.kernels import swa as TS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (n, window, h, hkv, d, batch): test_torch_swa.py's GEOMETRIES without
# the TPU's tiles, GQA (group 2) at head_dim 128, and a batch folded into
# BH with GQA
GEOMETRIES = [(256, 64, 2, 1, 32, 1), (256, 32, 4, 2, 32, 1),
              (512, 256, 2, 2, 64, 1), (256, 100, 2, 1, 32, 1),
              (128, 128, 2, 1, 16, 1), (256, 100, 4, 2, 128, 1),
              (128, 48, 4, 2, 64, 2)]
IDS = ["w64-g2-d32", "w32-g2-d32", "w256-d64", "w100-g2", "w128-d16",
       "w100-g2-d128", "batched-gqa"]
# each head_dim's (key chunk of the query-major pass, row slice of the
# key-major pass), both run on every geometry
WALKS = sorted({(TS.KEY_CHUNK[d], TS.ROW_SLICE[d]) for d in TS.KEY_CHUNK})
# fp32: the mirror and the plain backward are jax.grad's sums in another
# order, as test_torch_swa.py's fp32 3e-4
FP32_TOL = 3e-4
# bf16, max |mirror - jax.grad| over max |jax.grad| of each gradient: both
# round the gradient to bf16 once (2^-9 of its value, 2e-3); the mirror
# also rounds P and dS to bf16 before their products (2^-9 each, summed
# over up to 256 keys) and takes delta from the bf16 output, so a few ulps
# of the largest gradient, as moba_bwd's 3e-2 on the card
BF16_REL_TOL = 3e-2


def _inputs(bh, bkv, n, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(bh, n, d)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(bkv, n, d)) * 0.5).astype(np.float32)
    v = rng.normal(size=(bkv, n, d)).astype(np.float32)
    do = rng.normal(size=(bh, n, d)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, window, h, hkv, batch, dtype):
    """o and (dq, dk, dv) of the JAX package's dense attention with the
    window, in ``dtype``, on (BH, N, d) numpy inputs."""
    def four(x, heads):
        return jnp.asarray(x, dtype).reshape(batch, heads, *x.shape[1:])

    qj, kj, vj = four(q, h), four(k, hkv), four(v, hkv)
    o, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal=True,
                                               window=window), qj, kj, vj)
    grads = vjp(four(do, h))
    return (np.asarray(o, np.float32).reshape(q.shape),
            [np.asarray(g, np.float32).reshape(x.shape)
             for g, x in zip(grads, (q, k, v))])


def _bwd_mirror(q, k, v, o, lse, do, window, h, group, kc, r, bf16):
    """The backward kernel's arithmetic on the CPU, on (BH, N, d) / (BKV,
    N, d) tensors.  Query-major pass: each warp's 16 rows walk
    ``band_chunks`` with ``kc`` keys, delta = rowsum(dO o) in fp32, P =
    exp(S - lse) and dS = P (dP - delta) in fp32 from fp32 products of
    the inputs, dQ += dS K with dS rounded to bf16.  Key-major pass: each
    warp's 16 keys walk ``band_slices`` of ``r`` rows for each of the
    kv head's ``group`` query heads in turn, dV += P^T dO and dK += dS^T Q
    with P and dS rounded to bf16.  Masks only on chunks and slices marked
    masked.  ``bf16``: the roundings, and bf16 gradients."""
    bh, n, d = q.shape
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    scale = d ** -0.5
    delta = (dof * of).sum(-1)
    dq = torch.zeros(bh, n, d)
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)

    def band(rows, keys):
        return (keys[None] <= rows[:, None]) & (rows[:, None] - keys[None]
                                                < window)

    for b in range(bh):
        kv = (b // h) * (h // group) + (b % h) // group
        for r0 in range(0, n, TS.WARP_ROWS):
            rows = torch.arange(r0, min(r0 + TS.WARP_ROWS, n))
            acc = torch.zeros(len(rows), d)
            for c0, masked in TS.band_chunks(n, window, TS.WARP_ROWS, kc,
                                             r0):
                keys = torch.arange(c0, min(c0 + kc, n))
                p = torch.exp(qf[b, rows] @ kf[kv, keys].T * scale
                              - lse[b, rows, None])
                if masked:
                    p = torch.where(band(rows, keys), p, 0.0)
                ds = p * (dof[b, rows] @ vf[kv, keys].T
                          - delta[b, rows, None])
                acc += rnd(ds) @ kf[kv, keys]
            dq[b, rows] = acc * scale
    hkv = h // group
    for kv in range(k.shape[0]):
        bh0 = (kv // hkv) * h + (kv % hkv) * group
        for k0 in range(0, n, TS.WARP_ROWS):
            keys = torch.arange(k0, min(k0 + TS.WARP_ROWS, n))
            dka = torch.zeros(len(keys), d)
            dva = torch.zeros(len(keys), d)
            for b in range(bh0, bh0 + group):
                for s0, masked in TS.band_slices(n, window, TS.WARP_ROWS, r,
                                                 k0):
                    rows = torch.arange(s0, min(s0 + r, n))
                    pt = torch.exp(kf[kv, keys] @ qf[b, rows].T * scale
                                   - lse[b, rows][None])
                    if masked:
                        pt = torch.where(band(rows, keys).T, pt, 0.0)
                    dst = pt * (vf[kv, keys] @ dof[b, rows].T
                                - delta[b, rows][None])
                    dva += rnd(pt) @ dof[b, rows]
                    dka += rnd(dst) @ qf[b, rows]
            dk[kv, keys] = dka * scale
            dv[kv, keys] = dva
    out = (dq, dk, dv)
    return tuple(t.to(torch.bfloat16) for t in out) if bf16 else out


def _max_rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(np.array(x)).to(dtype) for x in xs]


@pytest.mark.parametrize("walk", WALKS, ids=[f"kc{a}-r{b}" for a, b in WALKS])
@pytest.mark.parametrize("n,window,h,hkv,d,batch", GEOMETRIES, ids=IDS)
def test_bwd_mirror_matches_jax_grad_fp32(n, window, h, hkv, d, batch,
                                          walk):
    """The two passes' walks and arithmetic, in fp32, give jax.grad's
    gradients within 3e-4."""
    q, k, v, do = _inputs(batch * h, batch * hkv, n, d, seed=n + window + d)
    o_j, want = _jax_grads(q, k, v, do, window, h, hkv, batch, jnp.float32)
    tq, tk, tv, tdo, to = _torch(q, k, v, do, o_j)
    lse = TS.swa_lse_plain(tq, tk, window, num_q_heads=h, group=h // hkv)
    got = _bwd_mirror(tq, tk, tv, to, lse, tdo, window, h, h // hkv, *walk,
                      bf16=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=name)


@pytest.mark.parametrize("walk", WALKS, ids=[f"kc{a}-r{b}" for a, b in WALKS])
@pytest.mark.parametrize("n,window,h,hkv,d,batch",
                         [GEOMETRIES[i] for i in (1, 2, 5, 6)],
                         ids=[IDS[i] for i in (1, 2, 5, 6)])
def test_bwd_mirror_matches_jax_grad_bf16(n, window, h, hkv, d, batch, walk):
    """With the kernel's bf16 roundings, from bf16 inputs and the bf16
    output, the gradients hold ``BF16_REL_TOL`` of each gradient's largest
    against jax.grad in bf16; the log-sum-exp comes from the plain version
    on the bf16 inputs."""
    q, k, v, do = _inputs(batch * h, batch * hkv, n, d, seed=n + window + d)
    o_j, want = _jax_grads(q, k, v, do, window, h, hkv, batch, jnp.bfloat16)
    tq, tk, tv, tdo, to = _torch(q, k, v, do, o_j, dtype=torch.bfloat16)
    lse = TS.swa_lse_plain(tq, tk, window, num_q_heads=h, group=h // hkv)
    got = _bwd_mirror(tq, tk, tv, to, lse, tdo, window, h, h // hkv, *walk,
                      bf16=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert _max_rel(g, w) <= BF16_REL_TOL, (name, _max_rel(g, w))


@pytest.mark.parametrize("n,window,h,hkv,d,batch", GEOMETRIES, ids=IDS)
def test_plain_backward_matches_jax_grad(n, window, h, hkv, d, batch):
    """``swa_backward_plain`` (the Function's backward on the CPU) and
    ``swa_lse_plain`` against jax.grad and ``jax.nn.logsumexp`` of the
    masked scores, fp32."""
    q, k, v, do = _inputs(batch * h, batch * hkv, n, d, seed=n + window)
    o_j, want = _jax_grads(q, k, v, do, window, h, hkv, batch, jnp.float32)
    tq, tk, tv, tdo, to = _torch(q, k, v, do, o_j)
    kw = dict(num_q_heads=h, group=h // hkv)
    lse = TS.swa_lse_plain(tq, tk, window, **kw)
    got = TS.swa_backward_plain(tq, tk, tv, to, lse, tdo, window, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=name)
    kr = np.repeat(k.reshape(batch, hkv, n, d), h // hkv, axis=1)
    s = np.einsum("bhqd,bhsd->bhqs", q.reshape(batch, h, n, d), kr)
    pos = np.arange(n)
    ok = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)
    want_lse = jax.nn.logsumexp(jnp.where(ok, s * d ** -0.5, -1e30), -1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(
        batch * h, n), rtol=1e-5, atol=1e-5)


def _lse_mirror(q, k, window, h, group, kc):
    """The log-sum-exp the bf16 forward body writes: its online softmax
    over each warp's ``band_chunks`` (scores in the log2 domain, the
    m_safe guard, l from the unrounded P), then (m_safe + log2 l) ln 2."""
    bh, n, d = q.shape
    qf, kf = q.float(), k.float()
    scale_log2 = d ** -0.5 * np.log2(np.e)
    out = torch.empty(bh, n)
    for b in range(bh):
        kv = (b // h) * (h // group) + (b % h) // group
        for r0 in range(0, n, TS.WARP_ROWS):
            rows = torch.arange(r0, min(r0 + TS.WARP_ROWS, n))
            m = torch.full((len(rows),), -1e30)
            l = torch.zeros(len(rows))
            for c0, masked in TS.band_chunks(n, window, TS.WARP_ROWS, kc,
                                             r0):
                keys = torch.arange(c0, min(c0 + kc, n))
                s = qf[b, rows] @ kf[kv, keys].T * scale_log2
                if masked:
                    ok = ((keys[None] <= rows[:, None])
                          & (rows[:, None] - keys[None] < window))
                    s = torch.where(ok, s, torch.tensor(-1e30))
                mx = torch.maximum(m, s.max(1).values)
                m_safe = mx.clamp(min=-5e29)
                l = l * torch.exp2(m - m_safe) + torch.exp2(
                    s - m_safe[:, None]).sum(1)
                m = mx
            out[b, rows] = (m.clamp(min=-5e29)
                            + torch.log2(l.clamp(min=1e-30))) * np.log(2.0)
    return out


@pytest.mark.parametrize("kc", sorted(set(TS.KEY_CHUNK.values())))
@pytest.mark.parametrize("n,window,h,hkv,d,batch",
                         [GEOMETRIES[i] for i in (1, 2, 5, 6)],
                         ids=[IDS[i] for i in (1, 2, 5, 6)])
def test_forward_lse_mirror_matches_plain(n, window, h, hkv, d, batch, kc):
    """The log-sum-exp the bf16 forward writes, on its chunk walk, equals
    ``swa_lse_plain`` on the same bf16 inputs within fp32 rounding."""
    q, k, _, _ = _inputs(batch * h, batch * hkv, n, d, seed=n + d)
    tq, tk = _torch(q, k, dtype=torch.bfloat16)
    want = TS.swa_lse_plain(tq, tk, window, num_q_heads=h, group=h // hkv)
    got = _lse_mirror(tq, tk, window, h, h // hkv, kc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _check_slices(n, window, r, k0):
    """The row slices of the key tile at ``k0`` and of each of its warps:
    every key's band covered once, no warp slice outside all of its keys'
    bands, every unmasked slice inside every key's band and below n, each
    warp's slices among the tile's."""
    tile = [s0 for s0, _ in TS.band_slices(n, window, TS.CTA_ROWS, r, k0)]
    assert tile == list(range(k0, tile[-1] + 1, r)) if tile else k0 >= n
    for w0 in range(k0, k0 + TS.CTA_ROWS, TS.WARP_ROWS):
        slices = TS.band_slices(n, window, TS.WARP_ROWS, r, w0)
        keys = np.arange(w0, min(w0 + TS.WARP_ROWS, n))
        if not len(keys):
            assert slices == [], (w0, slices)
            continue
        assert {s0 for s0, _ in slices} <= set(tile), (w0, slices, tile)
        seen = np.zeros(len(keys), np.int64)
        for s0, masked in slices:
            rows = np.arange(s0, s0 + r)
            band = ((keys[:, None] <= rows[None])
                    & (rows[None] - keys[:, None] < window)
                    & (rows[None] < n))
            assert band.any(), (w0, s0)                  # no wasted slice
            if not masked:                               # inside, below n
                full = np.arange(w0, w0 + TS.WARP_ROWS)
                assert ((full[:, None] <= rows[None])
                        & (rows[None] - full[:, None] < window)).all()
                assert rows[-1] < n, (w0, s0)
            seen += band.sum(1)
        np.testing.assert_array_equal(seen, np.minimum(n - keys, window))


@pytest.mark.parametrize("r", sorted(set(TS.ROW_SLICE.values())))
@pytest.mark.parametrize("n,window", [
    (8192, 256), (1024, 100), (512, 600), (512, 1), (256, 100), (256, 33),
    (40, 16), (1000, 1), (300, 512), (96, 40), (2048, 255), (1000, 100)])
def test_band_slices_cover_every_band(n, window, r):
    """The key-major pass's walk of query rows (``swa.band_slices``,
    mirrored by ``csrc/swa_bwd.cu``) on band_chunks' cases, with each
    head_dim's slice: N below a tile, window 1, window >= N, a ragged N
    (1000), a band edge on a slice edge (255)."""
    for k0 in range(0, n, TS.CTA_ROWS):
        _check_slices(n, window, r, k0)


# ------------------------------------------------------------ dispatch
def _qkv(*, b=2, h=4, hkv=2, nq=64, n=64, d=64, dtype=torch.bfloat16,
         seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).requires_grad_()
            for shape in ((b, h, nq, d), (b, hkv, n, d), (b, hkv, n, d))]


TRAINING = dict(causal=True, q_positions=None, kv_len=None)
CASES = {
    "training": ({}, {}, True),
    "training-d128": (dict(d=128), {}, True),
    "kv_len": ({}, dict(kv_len=torch.tensor(40)), False),
    "q_positions": ({}, dict(q_positions=torch.arange(64)), False),
    "nq-ne-nk": (dict(nq=16), {}, False),
    "causal-false": ({}, dict(causal=False), False),
    "fp32": (dict(dtype=torch.float32), {}, False),
    "head-dim-32": (dict(d=32), {}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_case(case):
    """Which inputs are the case the Function takes: a causal sequence
    over its own keys in bf16 at head_dim 64 or 128, and nothing else."""
    shape, args, want = CASES[case]
    q, k, v = _qkv(**shape)
    assert TS.training_case(q, k, v, **{**TRAINING, **args}) is want


@pytest.fixture
def spy(monkeypatch):
    """Counts ``swa.banded_attention`` calls (the Function's entry)."""
    calls = []
    real = TS.banded_attention

    def banded_attention(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(TS, "banded_attention", banded_attention)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_dispatch(case, spy):
    """The flash backend's SWA prefill sends exactly the training case to
    the Function (on the CPU its plain versions), and everything else to
    ``dense_attention``: the same output bit for bit.  The dense and MoBA
    kinds never take it."""
    shape, args, want = CASES[case]
    q, k, v = _qkv(**shape)
    cfg = AttentionConfig(window=24)
    kw = {**TRAINING, **args}
    got = B.get("flash").prefill(cfg, "swa", q, k, v, **kw)
    ref = dense_attention(q, k, v, window=24, **kw)
    assert len(spy) == int(want)
    if want:
        torch.testing.assert_close(got, ref, rtol=0, atol=0)  # plain fwd
    else:
        assert torch.equal(got, ref)
    if case == "training":
        B.get("flash").prefill(cfg, "dense", q, k, v, **kw)
        assert len(spy) == 1


def test_flash_dispatch_cpu_keeps_dense(spy):
    """On CPU tensors the training case runs the Function's plain forward,
    which keeps ``dense_attention``'s output bit for bit."""
    q, k, v = _qkv()
    cfg = AttentionConfig(window=24)
    got = B.get("flash").prefill(cfg, "swa", q, k, v, **TRAINING)
    assert len(spy) == 1
    assert torch.equal(got, dense_attention(q, k, v, window=24))


def test_flash_paged_paths_keep_dense(spy):
    """The paged engine's SWA paths (fresh and chunked prefill, decode)
    never take the Function, even in its dtype and head_dim."""
    be = B.get("flash")
    cfg = AttentionConfig(window=24)
    q, k, v = (t.detach() for t in _qkv(b=2, nq=32, n=32))
    post = torch.tensor([32, 20])
    pos = torch.arange(32)[None].expand(2, 32)
    be.paged_prefill(cfg, "swa", q, k, v, post_len=post, positions=pos)
    pages = 4
    cache = {"pages_k": torch.randn(pages, 16, 2, 64).bfloat16(),
             "pages_v": torch.randn(pages, 16, 2, 64).bfloat16()}
    table = torch.tensor([[0, 1], [2, 3]])
    kv_len = torch.tensor([16, 8])
    be.paged_chunk_prefill(cfg, "swa", q[:, :, :8], cache, table, kv_len,
                           torch.tensor([8, 8]))
    be.paged_decode(cfg, "swa", q[:, :, :1], cache, table, kv_len + 1)
    assert spy == []


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [dict(), dict(h=4, hkv=4, d=128, n=96,
                                                nq=96)], ids=["gqa", "d128"])
def test_function_grads_equal_dense_autograd(dtype, tol, shape):
    """Gradients through the Function on the CPU (its plain forward and
    backward) equal autograd of ``dense_attention``: fp32 within 1e-5;
    bf16 within one bf16 rounding of the largest gradient (2^-6 of it:
    both round in fp32 first, in another order)."""
    q, k, v = _qkv(dtype=dtype, **shape)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                     ).to(dtype)
    got = torch.autograd.grad(TS.banded_attention(q, k, v, 24), (q, k, v),
                              do)
    want = torch.autograd.grad(dense_attention(q, k, v, window=24),
                               (q, k, v), do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= \
            tol * float(w.float().abs().max())


def test_model_passes_no_positions_for_a_fresh_sequence(monkeypatch):
    """The model's cache-free attention hands dense and SWA layers no
    query positions when the caller gave none (the Function's case), and
    MoBA layers the positions (the sp backend sends them); positions the
    caller gave reach every kind."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers
    seen = []

    def record(a, kind, q, k, v, q_positions=None, **kw):
        seen.append((kind, q_positions))
        return torch.zeros_like(q)
    monkeypatch.setattr(layers, "attention_dispatch", record)
    cfg = get_smoke_config("moba-340m")
    dm, hd = cfg.d_model, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(0)
    p = {name: torch.randn(shape, generator=g) * 0.02 for name, shape in (
        ("wq", (dm, cfg.num_heads * hd)), ("wk", (dm, cfg.num_kv_heads * hd)),
        ("wv", (dm, cfg.num_kv_heads * hd)),
        ("wo", (cfg.num_heads * hd, dm)))}
    x = torch.randn(1, 8, dm, generator=g)
    for kind in ("swa", "moba", "dense"):
        layers.apply_attention(p, x, cfg, kind, backend="flash")
        layers.apply_attention(p, x, cfg, kind, backend="flash",
                               positions=torch.arange(8))
    got = {(kind, pos is None) for kind, pos in seen}
    assert got == {("swa", True), ("dense", True), ("moba", False),
                   ("swa", False), ("dense", False)}
