"""The plain reference against the port at a tiny size, on the CPU, on
the same weights and numpy token ids: logits, loss and every gradient
(SWA with RoPE, MoBA routing with the own block forced, SwiGLU, RMSNorm,
the embedding and the head), and AdamW's first steps."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import checks, reference, weights
from bench.conftest import tiny_config
from bench.runners import program

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    cfg = tiny_config()
    tokens = np.random.default_rng(7).integers(0, cfg["vocab_size"],
                                               (2, 97))
    return cfg, torch.as_tensor(tokens)


@pytest.mark.parametrize("backend", ["flash", "reference"])
def test_logits_loss_and_grads_match_the_port(case, backend):
    from repro_torch.models import transformer as T

    cfg, tokens = case
    mcfg = program.model_config(cfg)
    params = weights.make_params(cfg, 11, CPU)
    flat = reference.flatten(params)
    for p in flat.values():
        p.requires_grad_()
    loss, _ = T.lm_loss(params, {"tokens": tokens}, mcfg, backend=backend)
    grads = torch.autograd.grad(loss, list(flat.values()))
    logits, _, _ = T.lm_apply(params, tokens[:, :-1], mcfg,
                              backend=backend)

    ref_params = {k: v.detach().clone().requires_grad_()
                  for k, v in flat.items()}
    tree = reference._unflatten(ref_params)
    ref_loss = sum(reference.row_loss(tree, row, cfg, chunk=32)
                   for row in tokens) / len(tokens)
    ref_grads = torch.autograd.grad(ref_loss, list(ref_params.values()))
    with torch.no_grad():
        for r, row in enumerate(tokens[:, :-1]):
            pos = torch.arange(len(row))
            ref_logits = reference.logits_at(tree, row, pos, cfg, chunk=32)
            torch.testing.assert_close(logits[r].detach(), ref_logits,
                                       rtol=1e-5, atol=1e-5)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-5
    for name, g, rg in zip(flat, grads, ref_grads):
        torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-6, msg=name)


def test_adamw_steps_match_the_port(case):
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg, tokens = case
    batches = [tokens, tokens.flip(0), tokens.roll(5, 1)]
    params = weights.make_params(cfg, 12, CPU)
    p0 = {k: v.detach().clone() for k, v in
          reference.flatten(params).items()}
    opt = adamw.adamw_init(params)
    step = steps.make_train_step(program.model_config(cfg),
                                 program.train_config(cfg, 2, 96, 1),
                                 backend="flash")
    got = {"loss": [], "grad_norm": []}
    for i, b in enumerate(batches):
        params, opt, out = step(params, opt, {"tokens": b})
        got["loss"].append(float(out["loss"]))
        got["grad_norm"].append(float(out["grad_norm"]))
        if i == 0:
            got["first_grad"] = {k: float(m.norm()) / 0.1 for k, m in
                                 reference.flatten(opt.mu).items()}
    got["change"] = {k: float((p.detach() - p0[k]).norm())
                     for k, p in reference.flatten(params).items()}
    ref = reference.train_steps(p0, batches, cfg, CPU, chunk=32)
    numbers = checks.train_numbers(got, ref)
    assert max(numbers.values()) < 1e-4, numbers


def test_moba_selection_forces_the_own_block_and_masks_the_future():
    torch.manual_seed(0)
    q = torch.randn(2, 40, 8)
    k = torch.randn(2, 40, 8)
    sel = reference.moba_select(q, k, block=8, top_k=2, s=0, e=40)
    own = torch.arange(40) // 8
    blocks = torch.arange(5)
    assert sel[..., torch.arange(40), own].all()
    assert not (sel & (blocks > own[:, None])).any()
    assert (sel.sum(-1) == torch.clamp(own + 1, max=2)).all()
