"""The port's ranges (``repro_torch/tracing.py``) on the CPU profiler.

With no profiler session a range is a shared no-op and the autograd
graph carries no marker.  Under one, a training step records its phases,
each block's attention by kind, its MLP and the head, their backward as
``.bwd`` ranges and, under remat, their second forward inside
``train.backward``; the markers leave every gradient bit-identical.  An
engine step records its phases nested under ``engine.step``, and the
scheduler counts admissions and their queue wait.
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serving.engine import Engine, EngineConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("moba-340m")      # SWA and MoBA slots
    assert set(cfg.layer_pattern) == {"swa", "moba"}
    return cfg, T.init_lm(torch.Generator().manual_seed(0), cfg)


def _fresh(params):
    """A copy of ``params`` whose leaves need gradients."""
    return {k: _fresh(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_()
            for k, v in params.items()}


def _ranges(prof, prefixes=("train.", "model.", "kernel.", "engine.")):
    """(name, start, end) of the recorded ranges with those prefixes."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefixes)),
                  key=lambda r: (r[1], -r[2]))


def _inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _loss_grads(cfg, params, tokens, remat):
    leaves = [leaf.requires_grad_() for _, leaf in
              adamw.tree_leaves(params)]
    loss = T.lm_loss(params, {"tokens": tokens}, cfg, backend="flash",
                     remat=remat)[0]
    return loss, torch.autograd.grad(loss, leaves)


def test_no_session_is_a_shared_no_op(model):
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b")
    r = tracing.region("model.mlp")
    assert r is tracing.region("model.head")
    x, y = torch.ones(2, requires_grad=True), torch.zeros(2)
    with r as same:
        assert same.input(x) is x and same.output(x, y) == (x, y)
    cfg, params = model
    tokens = torch.randint(0, cfg.vocab_size, (1, 17),
                           generator=torch.Generator().manual_seed(1))
    loss = T.lm_loss(_fresh(params), {"tokens": tokens}, cfg,
                     backend="flash")[0]
    assert loss.grad_fn is not None
    assert not any("Bwd" in n for n in _graph_names(loss))
    with torch.profiler.profile(activities=CPU):
        marked = T.lm_loss(_fresh(params), {"tokens": tokens}, cfg,
                           backend="flash")[0]
    assert {"_OpenBwdBackward", "_CloseBwdBackward"} <= _graph_names(marked)
    assert torch.equal(loss, marked)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_markers_leave_gradients_bit_identical(model, remat):
    cfg, params = model
    tokens = torch.randint(0, cfg.vocab_size, (2, 49),
                           generator=torch.Generator().manual_seed(2))
    loss0, g0 = _loss_grads(cfg, _fresh(params), tokens, remat)
    with torch.profiler.profile(activities=CPU) as prof:
        loss1, g1 = _loss_grads(cfg, _fresh(params), tokens, remat)
    assert any(n.endswith(".bwd") for n, _, _ in _ranges(prof))
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_train_step_records_phases_layers_and_recompute(model):
    cfg, params = model
    params = _fresh(params)
    tcfg = TrainConfig(global_batch_size=2, seq_len=48, microbatch=2)
    step = S.make_train_step(cfg, tcfg, backend="flash", remat=True)
    opt = adamw.adamw_init(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 49),
                           generator=torch.Generator().manual_seed(3))
    with torch.profiler.profile(activities=CPU) as prof:
        step(params, opt, {"tokens": tokens})
    rs = _ranges(prof)
    names = [n for n, _, _ in rs]
    count = {n: names.count(n) for n in set(names)}
    assert count["train.step"] == 1 and count["train.optimizer"] == 1
    assert count["train.forward"] == count["train.backward"] == 2
    (step_r,) = [r for r in rs if r[0] == "train.step"]
    assert all(_inside(r, step_r) for r in rs)
    backward = [r for r in rs if r[0] == "train.backward"]
    forward = [r for r in rs if r[0] == "train.forward"]
    for kind in ("swa", "moba"):
        name = f"model.attn.{kind}"
        # one forward and one recompute a microbatch, one backward
        assert sum(any(_inside(r, f) for f in forward)
                   for r in rs if r[0] == name) == 2
        assert sum(any(_inside(r, b) for b in backward)
                   for r in rs if r[0] == name) == 2
        assert all(any(_inside(r, b) for b in backward)
                   for r in rs if r[0] == name + ".bwd")
        assert count[name + ".bwd"] == 2
    assert count["model.head.bwd"] == 4        # logits, then the loss
    assert count["model.mlp.bwd"] == 2 * cfg.num_layers
    assert count["model.weights.bwd"] == 2 * cfg.num_layers
    # FlashMoBA's own ranges nest inside the MoBA layers'
    for r in rs:
        if r[0] == "kernel.flash_moba_bwd":
            assert any(_inside(r, o) for o in rs
                       if o[0] == "model.attn.moba.bwd")


def test_engine_step_records_its_phases(model):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_seq_len=64,
                                           attn_backend="flash"),
                 device="cpu")
    rng = np.random.default_rng(0)
    for n in (20, 33):
        eng.submit(rng.integers(0, 256, n, dtype=np.int32),
                   max_new_tokens=4)
    with torch.profiler.profile(activities=CPU) as prof:
        eng.step()
    rs = _ranges(prof, ("engine.", "kernel.", "model."))
    (step_r,) = [r for r in rs if r[0] == "engine.step"]
    phases = {"engine.plan", "engine.prefill.build",
              "engine.prefill.dispatch", "engine.prefill.sync",
              "engine.decode.build", "engine.decode.dispatch",
              "engine.decode.sync", "engine.retire"}
    assert phases <= {n for n, _, _ in rs}
    assert all(_inside(r, step_r) for r in rs)
    order = [n for n, _, _ in rs if n in phases]
    assert order.index("engine.prefill.dispatch") \
        < order.index("engine.decode.dispatch") \
        < order.index("engine.retire")
    dispatch = [r for r in rs if r[0] == "engine.decode.dispatch"]
    decodes = [r for r in rs if r[0] == "kernel.moba_decode"]
    assert decodes and all(any(_inside(r, d) for d in dispatch)
                           for r in decodes)
    assert not any(n.endswith(".bwd") for n, _, _ in rs)   # no grad


def test_staged_api_reuses_the_phases(model):
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(max_seqs=2, max_seq_len=64,
                                           attn_backend="flash"),
                 device="cpu")
    req = eng.make_request(np.arange(1, 25, dtype=np.int32),
                           max_new_tokens=3)
    with torch.profiler.profile(activities=CPU) as prof:
        assert eng.insert(eng.prefill(req))
        eng.generate_step()
        eng.drain()
    names = {n for n, _, _ in _ranges(prof, ("engine.",))}
    assert {"engine.plan", "engine.prefill.dispatch", "engine.step",
            "engine.decode.dispatch", "engine.decode.sync",
            "engine.retire"} <= names
    assert eng.stats["admitted"] == 1 and eng.stats["queue_wait_s"] == 0.0


@pytest.mark.parametrize("swap_bytes", [0, 64 << 20],
                         ids=["recompute", "swap"])
def test_admissions_and_queue_wait(model, swap_bytes):
    """A starved pool preempts; each replay is one more admission."""
    cfg, params = model
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=3, max_seq_len=64, num_pages=8, swap_bytes=swap_bytes,
        attn_backend="flash"), device="cpu")
    rng = np.random.default_rng(4)
    reqs = [eng.submit(rng.integers(0, 256, n, dtype=np.int32),
                       max_new_tokens=14) for n in (40, 35, 30)]
    assert all(r.t_queued is not None for r in reqs)
    eng.step()
    assert eng.stats["admitted"] >= 1
    eng.run()
    assert eng.stats["preemptions"] > 0, "the case should preempt"
    assert eng.stats["admitted"] == len(reqs) + eng.stats["preemptions"]
    assert eng.stats["queue_wait_s"] > 0.0
    assert all(r.t_queued is None for r in reqs)
