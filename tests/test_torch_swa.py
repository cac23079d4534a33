"""Banded (sliding-window) flash attention of the PyTorch port against
the JAX package's Pallas ``swa_attention``, run in interpret mode on the
CPU as ``tests/test_swa_kernel.py`` runs it, on the same numpy inputs and
that file's geometries: fp32 within 3e-4, bf16 within 3e-2.

On CPU tensors the port's wrapper takes its plain version
(``dense_attention`` with the window); the CUDA kernel runs only on the
card (``chip_smoke.py``).  Its key-tile schedule — the reference's steps
formula and the 32-key chunks it skips — is replayed here and must cover
every query's band.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa import swa_attention as jax_swa
from repro_torch.kernels import swa as TS

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


def _visited_keys(n, window, q_tile, k_tile, q0):
    """Keys the CUDA kernel stages for the q tile at ``q0``: the steps
    formula's key tiles, in chunks of 32, less the chunks outside the
    tile's band (``csrc/swa.cu``)."""
    n_kv_tiles = n // k_tile
    steps = min((window - 1 + q_tile - 1) // k_tile + 2, n_kv_tiles)
    first = max(q0 - (window - 1), 0) // k_tile
    keys = set()
    for tile in range(first, first + steps):
        if tile >= n_kv_tiles:
            break
        end = (tile + 1) * k_tile
        for c0 in range(tile * k_tile, end, 32):
            rows = min(32, end - c0)
            if c0 > q0 + q_tile - 1 or c0 + rows - 1 < q0 - window + 1:
                continue
            keys.update(range(c0, c0 + rows))
    return keys


@pytest.mark.parametrize("n,window,qt,kt", [
    (8192, 256, 128, 128), (1024, 100, 128, 64), (512, 600, 128, 128),
    (512, 1, 64, 32), (256, 100, 64, 32), (256, 33, 32, 128)])
def test_kernel_schedule_covers_every_band(n, window, qt, kt):
    for q0 in range(0, n, qt):
        visited = _visited_keys(n, window, qt, kt, q0)
        need = set(range(max(q0 - window + 1, 0), q0 + qt))
        assert need <= visited, (q0, sorted(need - visited)[:4])


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
