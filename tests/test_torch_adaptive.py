"""SNR-guided adaptive routing in the PyTorch port against the JAX
package, on the same numpy inputs.

* **Policy core** (``core/adaptive.py``): ``parse_route_policy`` and
  ``choose_top_k`` on the cases of ``tests/test_adaptive_routing.py``,
  ``estimate_head_snr`` on the same arrays, ``RoutingProfile`` files
  written by one package and loaded by the other (the same JSON schema)
  with their validation errors, and ``calibrate_profile`` on converted
  JAX weights: budgets equal, measured SNRs within 1e-4.
* **Routing with per-head budgets** (``head_top_k``): ``select_blocks``,
  ``moba_selection``, ``moba_paged_route`` and ``moba_paged_prefill_route``
  bit-equal to JAX, tied scores included; the decode route kernel's
  plain version ``route_tables_plain`` equal to JAX's route plus
  ``union_pages``; the decode wrapper's plain version and the kernels'
  split pieces within 1e-3 of the Pallas kernel (interpret mode) with
  budgets.
* **Serving**: the capability gate; greedy tokens under a non-uniform
  profile equal to the JAX engine's (``reference``, ``xla``, ``flash``,
  chunked prefill, an int8 pool, kconv3, a GQA group of unequal
  budgets); static, a uniform profile and an snr policy that resolves to
  uniform budgets token-exact with static; preemption replay; the serve
  CLI's ``--route-policy``.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoBAConfig as JMoBAConfig
from repro.core import adaptive as JAD
from repro.core import moba as JM
from repro.core import routing as JR
from repro.kernels import moba_decode as JMD
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoBAConfig
from repro_torch.convert import from_jax
from repro_torch.core import adaptive as AD
from repro_torch.core import backends as B
from repro_torch.core import moba as TM
from repro_torch.core import routing as TR
from repro_torch.kernels import moba_decode as TMD
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import UnsupportedFeatureError

from test_torch_decode import DISAGREE, GEOMETRIES, _case
from test_torch_decode_split import ROUTE_GEOMETRIES
from torch_threads import one_thread_env, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = RTOL = 1e-3   # tests/test_backends.py:201


# ------------------------------------------------------------ policy core
@pytest.mark.parametrize("policy", [
    "static", "", "snr:pfail=0.01", " snr:pfail=0.25 ", "profile:/tmp/x.json",
    "snr", "snr:pfail=0.7", "snr:pfail=-1", "snr:p=0.1", "snr:pfail=x",
    "profile:", "greedy"])
def test_parse_route_policy_equals_jax(policy):
    try:
        want = JAD.parse_route_policy(policy)
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            AD.parse_route_policy(policy)
        assert str(ei.value) == str(e)
    else:
        assert AD.parse_route_policy(policy) == want


@pytest.mark.parametrize("snrs,num_blocks,k_max,pfail", [
    ([100.0], 64, 8, 0.01),              # own page reserved: floor is 2
    ([100.0], 64, 1, 0.01),              # ... unless the static k is 1
    (np.linspace(0.0, 12.0, 49), 64, 8, 0.01),
    (np.linspace(0.0, 12.0, 49), 64, 8, 0.05),
    (np.linspace(0.0, 12.0, 49), 64, 8, 0.001),
    ([0.0, 50.0], 4, 8, 0.01),           # k >= n: a vacuous bound
    ([[3.69, 6.64], [3.61, 5.11]], 33, 8, 0.01),
])
def test_choose_top_k_equals_jax(snrs, num_blocks, k_max, pfail):
    got = AD.choose_top_k(np.asarray(snrs), num_blocks, k_max, pfail)
    want = JAD.choose_top_k(np.asarray(snrs), num_blocks, k_max, pfail)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() <= k_max


def test_choose_top_k_properties():
    assert AD.choose_top_k(np.array([100.0]), 64, 8, 0.01).tolist() == [2]
    snrs = np.linspace(0.0, 12.0, 49)
    ks = AD.choose_top_k(snrs, 64, 8, 0.01)
    assert all(a >= b for a, b in zip(ks, ks[1:]))     # more SNR, fewer k
    assert ks[0] == 8 and ks[-1] == 2
    tight = AD.choose_top_k(snrs, 64, 8, 0.001)
    assert np.all(tight >= AD.choose_top_k(snrs, 64, 8, 0.05))
    with pytest.raises(ValueError, match="k_max"):
        AD.choose_top_k(np.array([1.0]), 64, 0, 0.01)


@pytest.mark.parametrize("case", ["random", "planted", "short"])
def test_estimate_head_snr_equals_jax(case):
    rng = np.random.default_rng(0)
    bs = 16
    if case == "short":      # fewer noise blocks than MIN_NOISE_BLOCKS
        scores = rng.standard_normal((2, 1, 2, 1, 3)).astype(np.float32)
        pos = np.array([3 * bs - 1])
    else:
        scores = rng.standard_normal((2, 3, 2, 40, 9)).astype(np.float32)
        pos = np.arange(40) + 9 * bs - 40
        if case == "planted":            # one head sees a strong block
            scores[:, 1, 0, :, 2] += 6.0
    got = AD.estimate_head_snr(torch.from_numpy(scores),
                               torch.from_numpy(pos), bs)
    want = JAD.estimate_head_snr(scores, pos, bs)
    np.testing.assert_array_equal(got, want)
    if case == "short":
        assert np.all(got == 0.0)
    if case == "planted":
        assert got[1, 0] > 2 * got[0, 0]


def _nonuniform(cfg, pkg=AD):
    """Every other head at budget 1 (own page only), the rest cycling
    through 2..top_k: a profile whose truncation changes the routing."""
    prof = pkg.RoutingProfile.uniform(cfg)
    k = prof.k_max
    for arr in prof.top_k.values():
        flat = arr.reshape(-1)
        for i in range(flat.size):
            flat[i] = 1 if i % 2 == 0 else 2 + (i // 2) % max(k - 1, 1)
        np.clip(arr, 1, k, out=arr)
    return prof


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_profile_files_cross_load(tmp_path, writer):
    """A profile saved by either package loads in the other with equal
    tables and fields."""
    cfg = get_smoke_config("qwen3-0.6b")
    src = _nonuniform(cfg, AD if writer == "torch" else JAD)
    src.snr = {s: [[0.5] * cfg.num_heads] * 2 for s in src.top_k}
    path = str(tmp_path / "prof.json")
    src.save(path)
    reader = JAD if writer == "torch" else AD
    back = reader.RoutingProfile.load(path)
    assert json.load(open(path))["version"] == 1
    assert (back.k_max, back.block_size, back.pfail, back.num_blocks) == \
        (src.k_max, src.block_size, src.pfail, src.num_blocks)
    assert set(back.top_k) == set(src.top_k) and back.snr == src.snr
    for s in src.top_k:
        np.testing.assert_array_equal(back.top_k[s], src.top_k[s])
    assert not back.is_uniform and AD.RoutingProfile.uniform(cfg).is_uniform


@pytest.mark.parametrize("bad", ["zero", "above", "shape"])
def test_profile_load_validation(tmp_path, bad):
    cfg = get_smoke_config("moba-340m")
    path = str(tmp_path / "prof.json")
    AD.RoutingProfile.uniform(cfg).save(path)
    doc = json.load(open(path))
    slot = next(iter(doc["top_k"]))
    if bad == "shape":
        doc["top_k"][slot] = [1, 2]
    else:
        doc["top_k"][slot][0][0] = 0 if bad == "zero" else doc["k_max"] + 1
    json.dump(doc, open(path, "w"))
    for pkg in (AD, JAD):
        with pytest.raises(ValueError, match="top_k|n_groups"):
            pkg.RoutingProfile.load(path)


def _smoke_pair(arch="moba-340m", top_k=None, **kw):
    """The smoke config in both packages (``top_k`` overridden) and the
    JAX weights with their port copy."""
    jcfg = jax_smoke_config(arch, **kw)
    cfg = get_smoke_config(arch, **kw)
    if top_k is not None:
        jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
            jcfg.attention, moba=dataclasses.replace(jcfg.attention.moba,
                                                     top_k=top_k)))
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, moba=dataclasses.replace(cfg.attention.moba,
                                                    top_k=top_k)))
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def model():
    return _smoke_pair()


@pytest.mark.parametrize("top_k,num_blocks,pfail", [
    (None, 4, 0.01),          # the smoke config: every budget 2 = k_max
    (8, 64, 0.1),             # k_max 8: budgets differ across heads
    (8, 33, 0.2),
])
def test_calibrate_profile_equals_jax(top_k, num_blocks, pfail):
    """The port's calibration pass on converted weights: the same budget
    tables as JAX's, the same measured SNRs within 1e-4 (the port's fp32
    scores may differ from XLA's in the last bits)."""
    jcfg, jparams, cfg, params = _smoke_pair(top_k=top_k)
    want = JAD.calibrate_profile(jcfg, jparams, pfail, num_blocks)
    got = AD.calibrate_profile(cfg, params, pfail, num_blocks)
    assert set(got.top_k) == set(want.top_k) == {"slot_1"}
    for s in want.top_k:
        np.testing.assert_array_equal(got.top_k[s], want.top_k[s])
        np.testing.assert_allclose(got.snr[s], want.snr[s], atol=1e-4)
    assert (got.k_max, got.num_blocks, got.block_size) == \
        (want.k_max, want.num_blocks, want.block_size)
    if top_k == 8:
        assert not got.is_uniform      # the tables above were not trivial


# ------------------------------------------------- routing with budgets
def _budgets(hkv, g, top_k, seed):
    """(Hkv, G) int32 budgets in [1, top_k] with both ends present."""
    rng = np.random.default_rng(seed)
    b = rng.integers(1, top_k + 1, (hkv, g)).astype(np.int32)
    flat = b.reshape(-1)
    flat[0] = 1
    flat[-1] = top_k
    return b


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
def test_select_blocks_and_selection_with_budgets_equal_jax(ties):
    rng = np.random.default_rng(4)
    b, hkv, g, nq, nb, bs, top_k = 2, 2, 3, 20, 6, 4, 4
    scores = rng.standard_normal((b, hkv, g, nq, nb)).astype(np.float32)
    if ties:     # signed zeros among the ties: np.round gives -0.0 too
        scores = np.round(scores)
    pos = np.arange(nq) + bs
    htk = _budgets(hkv, g, top_k, 1)
    got = TR.select_blocks(torch.from_numpy(scores), top_k, bs,
                           torch.from_numpy(pos),
                           head_top_k=torch.from_numpy(htk))
    want = JR.select_blocks(jnp.asarray(scores), top_k, bs,
                            jnp.asarray(pos), head_top_k=jnp.asarray(htk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got < nb).sum()) < int((TR.select_blocks(
        torch.from_numpy(scores), top_k, bs,
        torch.from_numpy(pos)) < nb).sum())
    q = rng.standard_normal((b, hkv * g, nq, 8)).astype(np.float32)
    k = rng.standard_normal((b, hkv, nb * bs, 8)).astype(np.float32)
    cfg = MoBAConfig(block_size=bs, top_k=top_k)
    jcfg = JMoBAConfig(block_size=bs, top_k=top_k)
    got = TM.moba_selection(torch.from_numpy(q), torch.from_numpy(k), cfg,
                            head_top_k=torch.from_numpy(htk))
    want = JM.moba_selection(jnp.asarray(q), jnp.asarray(k), jcfg,
                             head_top_k=jnp.asarray(htk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = TM.moba_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), cfg,
        head_top_k=torch.from_numpy(htk))
    jout = JM.moba_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jcfg,
        head_top_k=jnp.asarray(htk))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-4,
                               rtol=2e-4)


PAGED_GEOMS = ["g2-short-table", "g1", "g4-disagree", "long-table"]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("geom", PAGED_GEOMS)
def test_paged_routes_with_budgets_equal_jax(geom, ties):
    """Decode and chunked-prefill page routing truncated to per-head
    budgets: index- and validity-equal to JAX (the prefill route
    truncates before its row mask)."""
    g = ROUTE_GEOMETRIES[geom]
    q, cache, table, kv_lens = _case(g, tie_centroids=ties)
    hkv, gg = g["hkv"], g["h"] // g["hkv"]
    htk = _budgets(hkv, gg, g["top_k"], 7)
    cfg = MoBAConfig(block_size=g["ps"], top_k=g["top_k"])
    jcfg = JMoBAConfig(block_size=g["ps"], top_k=g["top_k"])
    t = [torch.from_numpy(x) for x in (cache["centroids"], table, kv_lens)]
    j = [jnp.asarray(x) for x in (cache["centroids"], table, kv_lens)]
    idx, val = TM.moba_paged_route(torch.from_numpy(q), *t, cfg,
                                   head_top_k=torch.from_numpy(htk))
    jidx, jval = JM.moba_paged_route(jnp.asarray(q), *j, jcfg,
                                     head_top_k=jnp.asarray(htk))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert bool((val.sum(-1) <= torch.from_numpy(htk)[..., None]).all())
    # a chunk of up to 8 queries ending at each row's length
    rng = np.random.default_rng(5)
    q_len = np.minimum(kv_lens, 8).astype(np.int32)
    pre = (kv_lens - q_len).astype(np.int32)
    qc = rng.standard_normal((len(kv_lens), g["h"], 8,
                              g["d"])).astype(np.float32)
    idx, val = TM.moba_paged_prefill_route(
        torch.from_numpy(qc), t[0], t[1], torch.from_numpy(pre),
        torch.from_numpy(q_len), cfg, head_top_k=torch.from_numpy(htk))
    jidx, jval = JM.moba_paged_prefill_route(
        jnp.asarray(qc), j[0], j[1], jnp.asarray(pre), jnp.asarray(q_len),
        jcfg, head_top_k=jnp.asarray(htk))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("geom", list(ROUTE_GEOMETRIES))
def test_route_tables_plain_with_budgets_match_jax(geom, ties):
    """The route kernel's outputs with budgets, from its plain version:
    selections equal to JAX's truncated route, union, physical pages,
    token bases and sizes equal to JAX's ``union_pages`` on it; the
    union never grows and shrinks somewhere."""
    g = ROUTE_GEOMETRIES[geom]
    q, cache, table, kv_lens = _case(g, tie_centroids=ties)
    hkv, gg, k, ps = g["hkv"], g["h"] // g["hkv"], g["top_k"], g["ps"]
    htk = _budgets(hkv, gg, k, 3)
    args = (torch.from_numpy(q), torch.from_numpy(cache["centroids"]),
            torch.from_numpy(table), torch.from_numpy(kv_lens), k, ps)
    got = TMD.route_tables_plain(*args, head_top_k=torch.from_numpy(htk))
    static = TMD.route_tables_plain(*args)
    jidx, jval = JM.moba_paged_route(
        jnp.asarray(q), jnp.asarray(cache["centroids"]), jnp.asarray(table),
        jnp.asarray(kv_lens), JMoBAConfig(block_size=ps, top_k=k),
        page_size=ps, head_top_k=jnp.asarray(htk))
    b = q.shape[0]
    want_sel = np.where(np.asarray(jval), np.asarray(jidx), -1)
    np.testing.assert_array_equal(got.sel.numpy(),
                                  want_sel.reshape(b * hkv, gg, k))
    npg = table.shape[1]
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
    np.testing.assert_array_equal(
        got.base.numpy(), np.where(member, union[:, None, :] * ps, npg * ps))
    assert bool((got.n_uniq <= static.n_uniq).all())
    assert bool((got.n_uniq < static.n_uniq).any())


@pytest.mark.parametrize("geom", list(GEOMETRIES) + ["g4-disagree"])
def test_decode_with_budgets_matches_jax_pallas(geom):
    """The public wrapper's plain version, and the kernels' split pieces
    (route tables, partials, merge), with budgets, against the TPU
    kernel with the same ``head_top_k`` in interpret mode."""
    g = GEOMETRIES.get(geom, DISAGREE)
    q, cache, table, kv_lens = _case(g)
    hkv, gg, k, ps = g["hkv"], g["h"] // g["hkv"], g["top_k"], g["ps"]
    htk = _budgets(hkv, gg, k, 9)
    t = {n: torch.from_numpy(cache[n]) for n in cache}
    tq, ttab, tkv = (torch.from_numpy(x) for x in (q, table, kv_lens))
    thtk = torch.from_numpy(htk)
    want = np.asarray(JMD.moba_paged_decode_pallas(
        jnp.asarray(q), jnp.asarray(cache["pages_k"]),
        jnp.asarray(cache["pages_v"]), jnp.asarray(cache["centroids"]),
        jnp.asarray(table), jnp.asarray(kv_lens),
        JMoBAConfig(block_size=ps, top_k=k), head_top_k=jnp.asarray(htk)))
    got = TMD.moba_paged_decode(tq, t["pages_k"], t["pages_v"],
                                t["centroids"], ttab, tkv,
                                MoBAConfig(block_size=ps, top_k=k),
                                head_top_k=thtk)
    active = kv_lens > 0
    np.testing.assert_allclose(got.numpy()[active], want[active], atol=ATOL,
                               rtol=RTOL)
    rt = TMD.route_tables_plain(tq, t["centroids"], ttab, tkv, k, ps,
                                head_top_k=thtk)
    b, h, _, d = q.shape
    p = TMD.plan(b, h, hkv, k, table.shape[1], ps, d, 4)
    o, m, l = TMD.decode_partials_plain(tq, t["pages_k"], t["pages_v"], tkv,
                                        rt, p)
    out = TMD.merge_partials_plain(o, m, l, rt.n_uniq, p, b, tq.dtype)
    np.testing.assert_allclose(out.numpy()[active], want[active], atol=ATOL,
                               rtol=RTOL)
    static = TMD.moba_paged_decode(tq, t["pages_k"], t["pages_v"],
                                   t["centroids"], ttab, tkv,
                                   MoBAConfig(block_size=ps, top_k=k))
    assert not torch.allclose(static[active], got[active], atol=ATOL)


@pytest.mark.parametrize("bad", ["int64", "shape", "strided"])
def test_check_contract_rejects_bad_budgets(bad):
    """Budgets reach the kernel as a contiguous int32 (Hkv, G) table."""
    q = torch.zeros((2, 8, 1, 64))
    pool = torch.zeros((10, 16, 2, 64))
    TMD.check_contract(q, pool, pool,
                       head_top_k=torch.ones((2, 4), dtype=torch.int32))
    htk = {"int64": torch.ones((2, 4), dtype=torch.int64),
           "shape": torch.ones((8,), dtype=torch.int32),
           "strided": torch.ones((4, 2), dtype=torch.int32).T}[bad]
    with pytest.raises(ValueError, match="head_top_k"):
        TMD.check_contract(q, pool, pool, head_top_k=htk)


# ---------------------------------------------------------------- serving
def test_capability_gate(model, monkeypatch):
    """Every backend of the port declares adaptive_topk; a backend that
    does not is refused for adaptive routing at admission."""
    _, _, cfg, params = model
    for name in ("reference", "xla", "flash"):
        for phase in ("prefill", "decode"):
            assert B.resolve(name, kind="moba", phase=phase, cache="paged",
                             adaptive=True).name == name

    class StaticOnly(B.XLABackend):
        name = "static_only"
        aliases = ()
        capabilities = dataclasses.replace(B.XLABackend.capabilities,
                                           adaptive_topk=False)

    monkeypatch.setitem(B._REGISTRY, "static_only", StaticOnly())
    monkeypatch.setitem(B._ALIASES, "static_only", "static_only")
    with pytest.raises(B.BackendCapabilityError, match="adaptive=True"):
        B.resolve("static_only", kind="moba", phase="decode", cache="paged",
                  adaptive=True)
    Engine(cfg, params, EngineConfig(attn_backend="static_only"),
           device="cpu")
    with pytest.raises(UnsupportedFeatureError) as ei:
        Engine(cfg, params, EngineConfig(attn_backend="static_only",
                                         route_policy="snr:pfail=0.01"),
               device="cpu")
    assert ei.value.feature == "attn_backend"


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.int32) for n in lens]


def _run(engine_cls, ecfg_cls, cfg, params, prompts, gen, **ecfg):
    kw = {"device": "cpu"} if engine_cls is Engine else {}
    eng = engine_cls(cfg, params, ecfg_cls(max_seq_len=64, **ecfg), **kw)
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    return [list(r.out) for r in reqs], eng


NONUNIFORM_CASES = {
    "reference": ("moba-340m", {}, dict(attn_backend="reference")),
    "xla": ("moba-340m", {}, dict(attn_backend="xla")),
    "flash": ("moba-340m", {}, dict(attn_backend="flash")),
    "flash-chunk7": ("moba-340m", {}, dict(attn_backend="flash",
                                           prefill_chunk=7)),
    "flash-int8": ("moba-340m", {}, dict(attn_backend="flash",
                                         kv_dtype="int8")),
    "kconv3-flash-chunk7": ("moba-340m", {"key_conv_width": 3},
                            dict(attn_backend="flash", prefill_chunk=7)),
    # G 2 (qwen3 smoke: 4 heads on 2 kv heads, all layers MoBA): the
    # union of a budget-1 head and a budget-2 head
    "qwen3-g2-flash": ("qwen3-0.6b", {}, dict(attn_backend="flash")),
}


@pytest.mark.parametrize("case", list(NONUNIFORM_CASES))
def test_nonuniform_profile_tokens_equal_jax(tmp_path, case):
    """The same non-uniform profile file served by both engines: equal
    greedy streams, which differ from static routing's."""
    arch, kw, ekw = NONUNIFORM_CASES[case]
    jcfg, jparams, cfg, params = _smoke_pair(arch, **kw)
    path = str(tmp_path / "prof.json")
    _nonuniform(cfg).save(path)
    prompts = _prompts((40, 33, 21), seed=9)
    ecfg = dict(max_seqs=3, route_policy=f"profile:{path}", **ekw)
    want, jeng = _run(JEngine, JEngineConfig, jcfg, jparams, prompts, 8,
                      **ecfg)
    got, eng = _run(Engine, EngineConfig, cfg, params, prompts, 8, **ecfg)
    assert got == want
    assert not eng.route_profile.is_uniform
    np.testing.assert_array_equal(eng.route_profile.top_k["slot_0" if arch
                                  == "qwen3-0.6b" else "slot_1"],
                                  jeng.route_profile.top_k[
                                      "slot_0" if arch == "qwen3-0.6b"
                                      else "slot_1"])
    static, _ = _run(Engine, EngineConfig, cfg, params, prompts, 8,
                     max_seqs=3, **ekw)
    assert got != static           # the truncation changed the routing


@pytest.mark.parametrize("ekw", [
    {}, dict(attn_backend="flash"), dict(prefill_chunk=7),
    dict(attn_backend="xla", kv_dtype="int8")],
    ids=["reference", "flash", "chunk7", "xla-int8"])
def test_static_and_uniform_profiles_token_exact(model, tmp_path, ekw):
    """A saved uniform profile and an snr policy that resolves to uniform
    budgets (k_max 2: every budget is min(k + 1, 2) = 2) decode the static
    streams exactly."""
    _, _, cfg, params = model
    path = str(tmp_path / "uniform.json")
    AD.RoutingProfile.uniform(cfg).save(path)
    prompts = _prompts((40, 33, 21), seed=7)
    base, eng = _run(Engine, EngineConfig, cfg, params, prompts, 8,
                     max_seqs=3, **ekw)
    assert eng.route_profile is None
    for policy in (f"profile:{path}", "snr:pfail=0.01"):
        outs, eng = _run(Engine, EngineConfig, cfg, params, prompts, 8,
                         max_seqs=3, route_policy=policy, **ekw)
        assert eng.route_profile.is_uniform, policy
        assert outs == base, policy


@pytest.mark.parametrize("swap_bytes", [0, 64 << 20],
                         ids=["recompute", "swap"])
def test_preemption_replay_under_profile(model, tmp_path, swap_bytes):
    """A starved pool preempts under a non-uniform profile; every
    request's stream equals its solo stream and the JAX engine's."""
    jcfg, jparams, cfg, params = model
    path = str(tmp_path / "prof.json")
    _nonuniform(cfg).save(path)
    policy = f"profile:{path}"
    prompts = _prompts((40, 35, 30), seed=4)
    ecfg = dict(max_seqs=3, num_pages=8, swap_bytes=swap_bytes,
                route_policy=policy, attn_backend="flash")
    got, eng = _run(Engine, EngineConfig, cfg, params, prompts, 14, **ecfg)
    assert eng.stats["preemptions"] > 0, "test should exercise preemption"
    want, _ = _run(JEngine, JEngineConfig, jcfg, jparams, prompts, 14,
                   **ecfg)
    assert got == want
    for p, out in zip(prompts, got):
        solo, _ = _run(Engine, EngineConfig, cfg, params, [p], 14,
                       max_seqs=1, route_policy=policy,
                       attn_backend="flash")
        assert solo[0] == out


def _bad_policy(cfg, tmp_path, bad) -> str:
    """A route policy the engine must refuse: a malformed string, a
    missing file, or a saved profile that does not fit ``cfg``."""
    if ":" in bad or bad == "greedy":
        return bad
    prof = AD.RoutingProfile.uniform(cfg)
    if bad == "k_max":
        prof.k_max = 4
    elif bad == "not_moba_slot":
        prof.top_k["slot_0"] = prof.top_k["slot_1"]
    elif bad == "shape":
        prof.top_k["slot_1"] = np.full((1, 3), 2, np.int32)
    path = str(tmp_path / "p.json")
    prof.save(path)
    if bad == "out_of_range":            # a budget above k_max on disk
        doc = json.load(open(path))
        doc["top_k"]["slot_1"][0][0] = doc["k_max"] + 1
        json.dump(doc, open(path, "w"))
    return f"profile:{path}"


@pytest.mark.parametrize("bad", [
    "snr:pfail=0.9", "greedy", "profile:/nonexistent.json", "k_max",
    "not_moba_slot", "shape", "out_of_range"])
def test_engine_rejects_bad_route_policy(model, tmp_path, bad):
    _, _, cfg, params = model
    policy = _bad_policy(cfg, tmp_path, bad)
    with pytest.raises(UnsupportedFeatureError) as ei:
        Engine(cfg, params, EngineConfig(max_seqs=1, max_seq_len=64,
                                         route_policy=policy), device="cpu")
    assert ei.value.feature == "route_policy"


@pytest.mark.parametrize("policy,rc", [("snr:pfail=0.01", 0),
                                       ("snr:pfail=0.9", 2)],
                         ids=["snr", "bad"])
def test_serve_cli_route_policy_on_cpu(policy, rc):
    env = one_thread_env(PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--mode", "batch", "--device", "cpu", "--attn-backend", "flash",
         "--batch", "2", "--gen", "4", "--route-policy", policy],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == rc, res.stderr
    if rc == 0:
        assert "routing profile: pfail=0.01" in res.stdout
        assert "decode tokens" in res.stdout
    else:
        assert "route_policy" in res.stderr
