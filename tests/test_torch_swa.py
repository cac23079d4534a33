"""Banded (sliding-window) flash attention of the PyTorch port against
the JAX package's Pallas ``swa_attention``, run in interpret mode on the
CPU as ``tests/test_swa_kernel.py`` runs it, on the same numpy inputs and
that file's geometries: fp32 within 3e-4, bf16 within 3e-2.

On CPU tensors the port's wrapper takes its plain version
(``dense_attention`` with the window); the CUDA kernel runs only on the
card (``chip_smoke.py``).  Its bf16 body's chunk list
(``swa.band_chunks``) is checked here against every query's band, and a
mirror of that body's arithmetic (the chunk list, fp32 products of bf16
inputs, P rounded once to bf16, the m_safe guard) against the Pallas
kernel in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa import swa_attention as jax_swa
from repro_torch.kernels import swa as TS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GEOMETRIES = [(256, 64, 64, 64, 2, 1, 32),      # tests/test_swa_kernel.py
              (256, 32, 128, 64, 4, 2, 32),
              (512, 256, 128, 128, 2, 2, 64),
              (256, 100, 64, 32, 2, 1, 16),
              (128, 128, 128, 128, 2, 1, 16)]


def _inputs(bh, bkv, n, d, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(bh, n, d)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(bkv, n, d)) * 0.5).astype(np.float32)
    v = rng.normal(size=(bkv, n, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n,window,qt,kt,h,hkv,d", GEOMETRIES)
def test_plain_matches_jax_kernel(n, window, qt, kt, h, hkv, d):
    q, k, v = _inputs(h, hkv, n, d, seed=n + window)
    want = jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window,
                   num_q_heads=h, group=h // hkv, q_tile=qt, k_tile=kt)
    got = TS.swa_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window, num_q_heads=h,
                           group=h // hkv, q_tile=qt, k_tile=kt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_plain_matches_jax_kernel_batched_gqa():
    """Batch folded into BH: two sequences of four heads on two kv heads
    each, so the kv row map crosses the batch boundary."""
    b, h, hkv, n, d, window = 2, 4, 2, 128, 32, 48
    q, k, v = _inputs(b * h, b * hkv, n, d, seed=3)
    want = jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window,
                   num_q_heads=h, group=h // hkv, q_tile=64, k_tile=32)
    got = TS.swa_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window, num_q_heads=h,
                           group=h // hkv, q_tile=64, k_tile=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_plain_matches_jax_kernel_bf16():
    q, k, v = _inputs(2, 2, 256, 32, seed=0)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = jax_swa(jq, jk, jv, 64, q_tile=64, k_tile=64)
    got = TS.swa_attention(tq, tk, tv, 64, q_tile=64, k_tile=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


def _check_band(n, window, kc, q0):
    """The chunks of ``kc`` keys of the tile at ``q0`` and of each of its
    warps: every row's band covered, no warp chunk outside all of its
    rows' bands, every unmasked chunk inside every row's band, each
    warp's chunks among the tile's."""
    tile = [c0 for c0, _ in TS.band_chunks(n, window, TS.CTA_ROWS, kc, q0)]
    for r0 in range(q0, q0 + TS.CTA_ROWS, TS.WARP_ROWS):
        chunks = TS.band_chunks(n, window, TS.WARP_ROWS, kc, r0)
        qpos = np.arange(r0, min(r0 + TS.WARP_ROWS, n))
        if not len(qpos):
            assert chunks == [], (r0, chunks)
            continue
        assert {c0 for c0, _ in chunks} <= set(tile), (r0, chunks, tile)
        seen = np.zeros(len(qpos), np.int64)
        for c0, masked in chunks:
            keys = np.arange(c0, c0 + kc)
            band = ((keys[None] <= qpos[:, None])
                    & (qpos[:, None] - keys[None] < window)
                    & (keys[None] < n))
            assert band.any(), (r0, c0)                   # no wasted chunk
            assert masked or band.all(), (r0, c0)        # unmasked: inside
            seen += band.sum(1)
        np.testing.assert_array_equal(seen, np.minimum(qpos + 1, window))


@pytest.mark.parametrize("kc", sorted(set(TS.KEY_CHUNK.values())))
@pytest.mark.parametrize("n,window", [
    (8192, 256), (1024, 100), (512, 600), (512, 1), (256, 100), (256, 33),
    (40, 16), (1000, 1), (300, 512), (96, 40), (2048, 255)])
def test_band_chunks_cover_every_band(n, window, kc):
    """The bf16 body's chunk list (``swa.band_chunks``, mirrored by
    ``csrc/swa.cu``) on the old schedule test's cases and ragged ones: N
    below a chunk, window 1, window >= N, N 96 (the reference's
    ``q_tile = min(128, N)``), a window whose band edge meets a chunk
    edge (255), with each head_dim's chunk."""
    for q0 in range(0, n, TS.CTA_ROWS):
        _check_band(n, window, kc, q0)


def _bf16_body_mirror(q, k, v, window, h, group, kc):
    """The bf16 kernel body's arithmetic on the CPU: each warp's chunks
    of ``kc`` keys from ``band_chunks``, Q·Kᵀ and P·V in fp32 from the
    bf16 inputs, the mask only on chunks marked masked, the online
    softmax with the reference's m_safe guard, P rounded once to bf16
    before P·V, l from the unrounded P floored at 1e-30, the output in
    bf16."""
    bh, n, d = q.shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    scale = d ** -0.5
    out = torch.empty(bh, n, d)
    for b in range(bh):
        kv = (b // h) * (h // group) + (b % h) // group
        for r0 in range(0, n, TS.WARP_ROWS):
            qpos = torch.arange(r0, min(r0 + TS.WARP_ROWS, n))
            m = torch.full((len(qpos),), -1e30)
            l = torch.zeros(len(qpos))
            acc = torch.zeros(len(qpos), d)
            for c0, masked in TS.band_chunks(n, window, TS.WARP_ROWS, kc,
                                             r0):
                keys = torch.arange(c0, min(c0 + kc, n))
                s = qf[b, qpos] @ kf[kv, keys].T * scale
                if masked:
                    ok = ((keys[None] <= qpos[:, None])
                          & (qpos[:, None] - keys[None] < window))
                    s = torch.where(ok, s, torch.tensor(-1e30))
                mx = torch.maximum(m, s.max(1).values)
                m_safe = mx.clamp(min=-5e29)
                alpha = torch.exp(m - m_safe)
                p = torch.exp(s - m_safe[:, None])
                l = l * alpha + p.sum(1)
                acc = (acc * alpha[:, None]
                       + p.to(torch.bfloat16).float() @ vf[kv, keys])
                m = mx
            out[b, qpos] = acc / l.clamp(min=1e-30)[:, None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("n,window,qt,kt,h,hkv,d,b", [
    (*GEOMETRIES[1], 1), (*GEOMETRIES[2], 1), (128, 48, 64, 32, 4, 2, 32, 2)],
    ids=["gqa-w32", "w256-d64", "batched-gqa"])
def test_bf16_body_mirror_matches_jax_kernel(n, window, qt, kt, h, hkv, d,
                                             b):
    """The bf16 body's arithmetic, with each head_dim's chunk, holds
    bf16's 3e-2 against the Pallas kernel in interpret mode, in bf16, on
    the same inputs."""
    q, k, v = _inputs(b * h, b * hkv, n, d, seed=n + window + d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = jax_swa(jq, jk, jv, window, num_q_heads=h, group=h // hkv,
                   q_tile=qt, k_tile=kt)
    for kc in sorted(set(TS.KEY_CHUNK.values())):
        got = _bf16_body_mirror(tq, tk, tv, window, h, h // hkv, kc)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=3e-2,
                                   atol=3e-2, err_msg=f"chunk {kc}")


def test_contract_errors():
    """Shaped errors where the reference asserts (tiles that do not divide
    N), for a head map that does not fit, and on the card's side for what
    the CUDA kernel does not take (checked before any launch)."""
    q, k, v = (torch.zeros(2, 256, 64) for _ in range(3))
    with pytest.raises(ValueError, match="divide N"):
        TS.swa_attention(q, k, v, 64, q_tile=96)
    with pytest.raises(ValueError, match="divide N"):
        TS.swa_attention(q, k, v, 64, k_tile=100)
    with pytest.raises(ValueError, match="BKV"):
        TS.swa_attention(q, k[:1], v[:1], 64, group=1)
    with pytest.raises(ValueError, match="window"):
        TS.swa_attention(q, k, v, 0)
    TS.check_contract(q, k, v, 128, 128)
    TS.check_contract(q.bfloat16(), k.bfloat16(), v.bfloat16(), 128, 64)
    d128 = torch.zeros(2, 256, 128)
    TS.check_contract(d128, d128, d128, 128, 128)
    with pytest.raises(ValueError, match="head_dim"):
        TS.check_contract(q[..., :32], k[..., :32], v[..., :32], 128, 128)
    with pytest.raises(ValueError, match="q_tile"):
        TS.check_contract(d128, d128, d128, 256, 128)
    with pytest.raises(ValueError, match="q_tile"):
        TS.check_contract(q, k, v, 48, 128)
    with pytest.raises(ValueError, match="dtype"):
        TS.check_contract(q, k.bfloat16(), v, 128, 128)
    with pytest.raises(ValueError, match="contiguous"):
        TS.check_contract(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v, 128, 128)


def test_contract_bf16_body():
    """The bf16 body takes the shapes the fp32 body's q_tile rule refuses
    and refuses, before any launch, what its own grid and copies cannot
    take: more than 65535 tiles, a misaligned tensor."""
    q, k, v = (torch.zeros(2, 256, 128, dtype=torch.bfloat16)
               for _ in range(3))
    TS.check_contract(q, k, v, 256, 128)             # fp32 would refuse
    TS.check_contract(q[..., :64].contiguous(), k[..., :64].contiguous(),
                      v[..., :64].contiguous(), 48, 128)
    n = 65535 * TS.CTA_ROWS
    big = torch.empty(1, n, 64, dtype=torch.bfloat16, device="meta")
    TS.check_contract(big, big, big, 128, 128)
    big = torch.empty(1, n + 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="65535 tiles"):
        TS.check_contract(big, big, big, 128, 128)
    flat = torch.zeros(2 * 256 * 128 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 256, 128)
    with pytest.raises(ValueError, match="aligned"):
        TS.check_contract(shifted, k, v, 128, 128)


def test_device_dispatch():
    """CPU tensors take the plain version without touching the launch
    counter; other devices raise."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 128, 16, seed=1))
    before = TS.LAUNCHES
    out = TS.swa_attention(q, k, v, 32, num_q_heads=2, group=2)
    assert TS.LAUNCHES == before
    want = TS.swa_attention_plain(q, k, v, 32, num_q_heads=2, group=2)
    assert torch.equal(out, want)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="meta"):
        TS.swa_attention(*meta, 32, num_q_heads=2, group=2)
