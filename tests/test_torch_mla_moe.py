"""A latent-attention MoE model in the port (Moonlight-16B-A3B's block:
MLA into FlashMoBA at unequal q/k and v widths, DeepSeek-V3's sigmoid
routing with a selection bias over the experts one device holds,
dropless, a leading dense layer) against the benchmark's plain reference
(``bench/reference_latent_moe.py``), at a smoke size on the CPU, fp32:
logits, loss and every gradient of the training loss; the routing's
selections with and without a bias; the expert shares of a layer
summing to the uncut layer; no pair dropped under the worst imbalance;
the bias update's sign rule over a step; and the plain versions of the
four FlashMoBA kernels at q/k 192 and v 128 against autograd of dense
masked attention.
"""
import json
import pathlib

import pytest
import torch

from bench import reference as R
from bench import reference_latent_moe as RM
from bench.runners import train_moe
from repro_torch.configs import moonlight_16b_a3b as ML
from repro_torch.configs.base import MoBAConfig, TrainConfig
from repro_torch.core.moba import moba_selection
from repro_torch.kernels import (centroids, flash_topk, moba_bwd, moba_fwd,
                                 ops, ref)
from repro_torch.launch import steps
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "bench/configs/moonlight-16b-a3b.json")
                    .read_text())


def _case(held: int = 8, held_first: int = 0, seed: int = 3):
    """(file config, port config, params, flat params) at smoke size."""
    cfg = RM.smoke_config(CONFIG, held=held, held_first=held_first)
    params = RM.make_params(cfg, seed, torch.device("cpu"))
    return cfg, train_moe.model_config(cfg), params, R.flatten(params)


def test_the_smoke_config_module_is_the_files_cut():
    _, mcfg, _, _ = _case()
    smoke = ML.get_smoke_config(held_count=8)
    keep = ("num_layers", "d_model", "num_heads", "d_ff", "vocab_size",
            "rms_norm_eps", "moe", "mla", "first_k_dense")
    assert {k: getattr(mcfg, k) for k in keep} == \
        {k: getattr(smoke, k) for k in keep}
    assert mcfg.router == smoke.router and mcfg.held_experts == (0, 8)
    full = train_moe.model_config(CONFIG)
    assert full.held_experts == (0, 8) and full.moe.num_experts == 64
    assert full.mla.qk_head_dim == 192 and full.mla.v_head_dim == 128


def test_logits_loss_and_every_gradient_match_the_reference():
    cfg, mcfg, params, flat = _case()
    tokens = torch.randint(0, cfg["vocab_size"], (2, 49),
                           generator=torch.Generator().manual_seed(1))
    for p in flat.values():
        p.requires_grad_()
    state = T.init_router_state(mcfg, "cpu")
    state["router_bias"].normal_(0, 0.05,
                                 generator=torch.Generator().manual_seed(2))
    loss, _ = T.latent_lm_loss(params, {"tokens": tokens}, mcfg,
                               backend="flash", state=state)
    grads = torch.autograd.grad(loss, list(flat.values()))
    logits, _ = T.latent_lm_apply(params, tokens[:, :-1], mcfg,
                                  backend="flash", state=state)

    bias = state["router_bias"].clone()
    ref_params = {k: v.detach().clone().requires_grad_()
                  for k, v in flat.items()}
    tree = R._unflatten(ref_params)
    rows = [RM.row_loss(tree, row, cfg, bias, chunk=16) for row in tokens]
    ref_loss = sum(r[0] for r in rows) / len(rows)
    ref_grads = torch.autograd.grad(ref_loss, list(ref_params.values()))
    for r, row in enumerate(tokens[:, :-1]):
        torch.testing.assert_close(
            logits[r].detach(), RM.logits_at(tree, row, cfg, bias, chunk=16),
            rtol=1e-5, atol=1e-5)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-5
    for name, g, rg in zip(flat, grads, ref_grads):
        torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-6, msg=name)
    # the step's counters: every pair of every MoE layer counted once
    counts = sum(r[1] for r in rows)
    torch.testing.assert_close(state["expert_counts"] / 2, counts)


@pytest.mark.parametrize("bias_std", [0.0, 0.3])
def test_routing_selections_are_the_references(bias_std):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(300, 64, generator=gen)
    router = torch.randn(64, 64, generator=gen) / 8
    bias = torch.randn(64, generator=gen) * bias_std
    s, top_e, g = MOE.sigmoid_route(router, x, bias, 6, 2.446)
    rs, ridx, rg = RM.route(router, x, bias, CONFIG)
    assert torch.equal(top_e, ridx)
    assert torch.equal(s, rs)
    torch.testing.assert_close(g, rg, rtol=1e-6, atol=0)
    if bias_std:       # the bias moves selections, not weights
        _, plain, _ = MOE.sigmoid_route(router, x, torch.zeros(64), 6, 2.446)
        assert not torch.equal(plain, top_e)
        torch.testing.assert_close(g.sum(-1), torch.full((300,), 2.446))


def _layer(held: int, held_first: int):
    cfg, mcfg, params, _ = _case(held=held, held_first=held_first)
    return cfg, mcfg, params["layers"]["layer_01"]["moe"]


def test_the_shares_of_a_layer_sum_to_the_uncut_layer():
    cfg, mcfg, p_all = _layer(64, 0)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 40, 64, generator=gen)
    bias = torch.randn(64, generator=gen) * 0.1
    with torch.no_grad():
        ref_out = torch.stack([RM.held_moe(p_all, row, bias, cfg,
                                           R.identity)[0] for row in x])
        shared = MOE.apply_mlp(p_all["shared"], x)
        total = shared.clone()
        for first in range(0, 64, 8):
            _, mc, _ = _layer(8, first)
            share = dict(p_all, experts={k: w[first:first + 8] for k, w
                                         in p_all["experts"].items()})
            out, _, _ = MOE.apply_held_moe(share, x, mc, bias)
            total += out - shared
    torch.testing.assert_close(total, ref_out, rtol=1e-5, atol=1e-5)


def test_no_pair_is_dropped_when_every_token_routes_to_the_same_experts():
    cfg, mcfg, p = _layer(8, 0)
    x = torch.randn(1, 96, 64, generator=torch.Generator().manual_seed(6))
    bias = torch.zeros(64)
    bias[2:8] = 100.0          # every token's top 6: experts 2..7
    with torch.no_grad():
        out, _, counts = MOE.apply_held_moe(p, x, mcfg, bias)
        ref_out, _, ref_counts = RM.held_moe(p, x[0], bias, cfg, R.identity)
    assert counts[2:8].tolist() == [96.0] * 6 and counts.sum() == 96 * 6
    torch.testing.assert_close(counts, ref_counts)
    torch.testing.assert_close(out[0], ref_out, rtol=1e-5, atol=1e-5)
    # and none of them held: the routed part is empty, the shared one stays
    bias = torch.zeros(64)
    bias[40:46] = 100.0
    with torch.no_grad():
        out, _, _ = MOE.apply_held_moe(p, x, mcfg, bias)
    torch.testing.assert_close(out, MOE.apply_mlp(p["shared"], x))


def test_a_bounded_buffer_computes_what_every_pairs_rows_do():
    cfg, mcfg, p = _layer(8, 0)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 48, 64, generator=gen)
    bias = torch.randn(64, generator=gen) * 0.1
    leaves = [x, p["router"], *p["experts"].values()]
    g_out = torch.randn(2, 48, 64, generator=gen)

    def run(bound, over=None):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        q = dict(p, router=xs[1], experts=dict(zip(p["experts"], xs[2:])))
        out, aux, counts = MOE.apply_held_moe(q, xs[0], mcfg, bias, bound,
                                              over)
        return out, torch.autograd.grad((out * g_out).sum() + aux, xs), \
            counts

    out, grads, counts = run(0)
    held = int(counts[:8].sum())
    bound = MOE.held_bound(96, mcfg)
    assert held < bound < 96 * 6            # rows past the held pairs
    over = torch.zeros((), dtype=torch.bool)
    b_out, b_grads, b_counts = run(bound, over)
    assert not over and torch.equal(b_counts, counts)
    torch.testing.assert_close(b_out, out, rtol=0, atol=0)
    for a, b in zip(b_grads, grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    run(held - 1, over)                     # one pair past the buffer
    assert over


def test_a_step_whose_pairs_outgrow_the_buffer_takes_them_all_again(
        monkeypatch):
    cfg, mcfg, params, flat = _case()
    gen = torch.Generator().manual_seed(10)
    batches = [torch.randint(0, cfg["vocab_size"], (2, 33), generator=gen)
               for _ in range(2)]
    results = {}
    for slack in (0.1, 2.0):        # buffers too small; large enough
        monkeypatch.setattr(MOE, "HELD_SLACK", slack)
        state = T.init_router_state(mcfg, "cpu")
        step = steps.make_train_step(
            mcfg, TrainConfig(global_batch_size=2, seq_len=32, microbatch=2),
            backend="flash", state=state)
        p = R._unflatten({k: v.detach().clone() for k, v in flat.items()})
        opt = adamw.adamw_init(p)
        outs = []
        for tokens in batches:
            p, opt, out = step(p, opt, {"tokens": tokens})
            outs.append(out)
        assert not state["held_over"]
        results[slack] = (R.flatten(p), outs, state["router_bias"].clone())
    (p_re, out_re, b_re), (p_all, out_all, b_all) = results.values()
    assert [o["retaken"] for o in out_re] == [True, True]
    assert [o["retaken"] for o in out_all] == [False, False]
    for a, b in zip(out_re, out_all):
        assert torch.equal(a["expert_counts"], b["expert_counts"])
        assert float(a["loss"]) == float(b["loss"])
    assert torch.equal(b_re, b_all)
    for k in p_all:
        torch.testing.assert_close(p_re[k], p_all[k], rtol=0, atol=0, msg=k)


def test_the_bias_moves_by_the_sign_rule_after_each_step():
    cfg, mcfg, params, flat = _case()
    state = T.init_router_state(mcfg, "cpu")
    step = steps.make_train_step(mcfg, TrainConfig(global_batch_size=2,
                                                   seq_len=32, microbatch=2),
                                 backend="flash", state=state)
    opt = adamw.adamw_init(params)
    gen = torch.Generator().manual_seed(7)
    bias = torch.zeros_like(state["router_bias"])
    for _ in range(2):
        tokens = torch.randint(0, cfg["vocab_size"], (2, 33), generator=gen)
        params, opt, out = step(params, opt, {"tokens": tokens})
        c = out["expert_counts"]
        assert torch.equal(c.sum(-1), torch.full((2,), 2 * 32 * 6.0))
        mean = c.mean(-1, keepdim=True)
        want = bias + 1e-3 * ((c < mean).float() - (c > mean).float())
        torch.testing.assert_close(state["router_bias"], want, rtol=0,
                                   atol=1e-9)
        assert not state["expert_counts"].any()   # zeroed for the next step
        bias = want
    ref = RM.train_steps({k: v.detach() for k, v in flat.items()}, [],
                         cfg, torch.device("cpu"))
    assert not ref["bias"].any()


# ------------------------------------ the plain kernels at q/k 192, v 128
def _qkv(n: int = 64, h: int = 2, seed: int = 8):
    gen = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(1, h, n, 192, generator=gen) * 0.5 for _ in range(2))
    v = torch.randn(1, h, n, 128, generator=gen)
    return q, k, v


def test_flash_moba_at_192_128_matches_dense_autograd():
    q, k, v = (x.requires_grad_() for x in _qkv())
    cfg = MoBAConfig(block_size=16, top_k=2)
    out = ops.flash_moba(q, k, v, cfg)
    assert out.shape == (1, 2, 64, 128)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), g)
    sel = moba_selection(q, k, cfg, torch.arange(64)).long()
    blk = torch.zeros(1, 2, 64, 5, dtype=torch.bool).scatter_(
        -1, sel.clamp(max=4), True)[..., :4]
    pos = torch.arange(64)
    mask = blk.repeat_interleave(16, -1) & (pos[None] <= pos[:, None])
    s = (q @ k.transpose(-1, -2)) * 192 ** -0.5
    dense = torch.softmax(s.masked_fill(~mask, -float("inf")), -1) @ v
    torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-5)
    for a, b in zip(grads, torch.autograd.grad(dense, (q, k, v), g)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_centroids_and_flash_topk_at_192():
    q, k, _ = _qkv(n=72)
    kf = k.reshape(2, 72, 192)
    c = centroids.block_centroids_kernel(kf, 16)
    want = torch.stack([kf[:, i:i + 16].mean(1) for i in range(0, 72, 16)],
                       1)
    torch.testing.assert_close(c, want)
    sel = flash_topk.flash_topk(q.reshape(2, 72, 192), c, 3, 16)
    scores = q.reshape(2, 72, 192) @ c.transpose(-1, -2)
    for t in (40, 50, 71):
        own = t // 16
        past = scores[:, t, :own].topk(2).indices.sort(-1).values
        got = sel[:, t].sort(-1).values
        assert torch.equal(got[:, :2], past) and (got[:, 2] == own).all()


def test_the_kernel_contracts_take_192_128_and_nothing_unequal_else():
    tb = torch.zeros((2, 1), dtype=torch.int32)
    qp = torch.zeros((2, 16), dtype=torch.int32)
    for dq, dv, ok in ((192, 128, True), (64, 64, True), (128, 128, True),
                       (192, 192, False), (128, 64, False)):
        kb = torch.zeros((2, 1, 16, dq), dtype=torch.bfloat16)
        vb = torch.zeros((2, 1, 16, dv), dtype=torch.bfloat16)
        qs = torch.zeros((2, 16, dq), dtype=torch.bfloat16)
        do = torch.zeros((2, 16, dv), dtype=torch.bfloat16)
        lse = torch.zeros((2, 16))
        calls = [lambda: moba_fwd.check_contract(tb, qs, qp, kb, vb, 16, 16,
                                                 2, 1),
                 lambda: moba_bwd.check_contract(qs, do, lse, lse, kb, vb,
                                                 tb, qp, 16, 2, 1)]
        for call in calls:
            if ok:
                call()
            else:
                with pytest.raises(ValueError, match="head_dim"):
                    call()
    centroids.check_contract(torch.zeros((2, 16, 192)), 16)
    q = torch.zeros((2, 16, 192), dtype=torch.bfloat16)
    flash_topk.check_contract(q, q, 8, 1, 2, 0)
    with pytest.raises(ValueError, match="192 a top_k"):
        flash_topk.check_contract(q, q, 64, 1, 2, 0)
    assert moba_fwd.resolve_kb_tile(0, 128, 192, torch.float32) == 64
    assert moba_fwd.resolve_kb_tile(0, 128, 192, torch.bfloat16) == 128
    assert moba_fwd.resolve_kb_tile(0, 128) == 128


def test_the_plain_partials_and_backward_take_unequal_widths():
    q, k, v = _qkv(n=48)
    qf = ops.padded_queries(q, 16)
    kb, nb = ops.flatten_kv_blocks(k, 16)
    vb, _ = ops.flatten_kv_blocks(v, 16)
    cents = ref.centroids_ref(k.reshape(2, 48, 192), 16)
    sel = ref.flash_topk_ref(qf, cents, 2, 16, num_q_heads=2)
    lay, qs, qp = ops.sorted_layout(qf, sel, 48, nb, 16, 0)
    kw = dict(scale=192 ** -0.5, block_size=16, n_tokens=48, num_q_heads=2,
              group=1)
    o, m, l = ref.moba_partials_ref(lay.tile_block, qs, qp, kb, vb, **kw)
    assert o.shape == qs.shape[:-1] + (128,)
    do = torch.randn(o.shape)
    g = ref.moba_bwd_ref(lay.tile_block, qs, qp, do, m, torch.zeros_like(m),
                         kb, vb, **kw)
    assert g.dq_sorted.shape == qs.shape
    assert g.dk_blocks.shape[-1] == 192 and g.dv_blocks.shape[-1] == 128
