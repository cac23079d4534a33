"""Named ranges at the port's layer boundaries, on the profiler's clock.

Run the program under ``torch.profiler.profile`` and every boundary
below appears in the trace as a ``user_annotation`` range, beside the
kernels it launched and on the same clock.  Without a profiler session a
boundary costs one call and one boolean check, and the autograd graph is
the same as without it.  There is no other switch.

Ranges are named ``<layer>.<what>``:

  train.step, train.forward, train.backward, train.optimizer
      ``launch/steps.py``: one optimizer step; each microbatch's loss;
      each ``torch.autograd.grad`` with its gradient accumulation; AdamW.
  model.attn.<kind>, model.mlp, model.head, model.weights
      ``models/transformer.py``: an attention block's pre-norm and self
      attention (``<kind>``: the attention it runs, ``swa``, ``moba`` or
      ``dense``); its pre-norm and MLP or MoE; the final norm and logits
      (and the loss of ``lm_loss``); a block's views of the stacked
      weights.  Under ``remat`` the forward ranges open again inside
      ``train.backward``, on the autograd thread: that is the recompute.
  model.mla.kv
      ``models/layers.py``, inside a latent-attention block's
      ``model.attn.<kind>``: the latent down-projection, its RMSNorm, the
      up-projection to every head's key and value, and the shared key's
      RoPE.
  model.moe.route, model.moe.dispatch, model.moe.experts,
  model.moe.combine, model.moe.shared
      ``models/moe.py::apply_held_moe``, inside ``model.mlp``: sigmoid
      scores, the biased top-k, the weights, the balance loss and the
      pairs sorted by expert; the held pairs' rows gathered into a
      buffer of a row count fixed on the host; the held experts'
      grouped SwiGLU; the weighted sum back to the tokens; the shared
      experts.  Nothing is read back.  The step's per-expert pair
      counts are its counter (``expert_counts`` of the training step's
      output, with ``retaken``, whether the step took its gradients
      again over every pair; ``moe.routing_counters`` reads them).
  model.attn.<kind>.bwd, model.mlp.bwd, model.head.bwd, model.weights.bwd
      the backward of those regions, on the thread autograd runs it on;
      ``model.weights.bwd`` assembles a block's weight gradients into the
      stacks' (and ``model.mla.kv.bwd``, ``model.moe.<what>.bwd`` those of
      the regions inside a block).
  kernel.flash_moba, kernel.flash_moba_bwd, kernel.moba_decode,
  kernel.swa, kernel.swa_bwd
      ``kernels/ops.py``, ``kernels/moba_decode.py`` and
      ``kernels/swa.py``: FlashMoBA's forward and backward, one paged
      MoBA decode call, and the SWA layers' banded training attention,
      forward (recomputes included) and backward.
  engine.step, engine.plan, engine.prefill.build,
  engine.prefill.dispatch, engine.prefill.sync, engine.decode.build,
  engine.decode.dispatch, engine.decode.sync, engine.retire
      ``serving/engine.py``: one engine iteration; admission, growth and
      the planned cache ops; a prefill's host batch and its upload, its
      launch, its wait for the sampled tokens; the same for a decode
      step; retiring finished requests and the counters.

A forward range cannot hold a region's backward, which autograd runs
later, on its own thread for device tensors.  :func:`region` therefore
adds two identity ``torch.autograd.Function`` markers while a profiler
session runs: the one on the region's output opens ``<name>.bwd`` in its
backward, the one on the region's input closes it (it carries no
gradient, so every sum is taken as without it).  Autograd runs the ready
node of the highest sequence number first, so in a chain of blocks the
region's own backward nodes run between the two markers.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a profiler session records ranges on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A range named ``name`` while a profiler session runs; otherwise a
    shared no-op context."""
    if enabled():
        return torch.profiler.record_function(name)
    return _NULL


class _Bwd:
    """The open ``<name>.bwd`` range of one region's backward."""
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name, self.record = name, None


class _CloseBwd(torch.autograd.Function):
    """Takes a region's inputs and gives an empty token; its backward
    closes the range and gives the inputs no gradient (their gradients
    flow along the region's own graph, summed as without the marker)."""

    @staticmethod
    def forward(ctx, bwd, *xs):
        ctx.bwd = bwd
        return xs[0].new_empty(0)

    @staticmethod
    def backward(ctx, _):
        b = ctx.bwd
        if b.record is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(
                b.record)
            b.record = None
        return (None,) * len(ctx.needs_input_grad)


class _OpenBwd(torch.autograd.Function):
    """Identity on a region's outputs, tied to the region's token; its
    backward opens the range and hands the token a gradient, so the
    closing marker runs once autograd reaches it."""

    @staticmethod
    def forward(ctx, bwd, token, *xs):
        ctx.bwd = bwd
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        b = ctx.bwd
        if b.record is None and enabled():
            b.record = torch.ops.profiler._record_function_enter_new(
                b.name, None)
        g = next((x for x in grads if x is not None), None)
        token = None if g is None else g.new_empty(0)
        return (None, token, *grads)


def _needing_grad(xs):
    return [i for i, x in enumerate(xs)
            if isinstance(x, torch.Tensor) and x.requires_grad]


class _Region:
    """A differentiable region under a profiler session."""

    def __init__(self, name: str):
        self._range = torch.profiler.record_function(name)
        self._bwd: Optional[_Bwd] = (_Bwd(name + ".bwd")
                                     if torch.is_grad_enabled() else None)
        self._token = None

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        return self._range.__exit__(*exc)

    def input(self, *xs):
        idx = _needing_grad(xs) if self._bwd is not None else []
        if idx:
            self._token = _CloseBwd.apply(self._bwd, *(xs[i] for i in idx))
        return xs[0] if len(xs) == 1 else xs

    def output(self, *xs):
        idx = _needing_grad(xs) if self._token is not None else []
        if idx:
            out = list(xs)
            for i, y in zip(idx, _OpenBwd.apply(self._bwd, self._token,
                                                *(xs[i] for i in idx))):
                out[i] = y
            xs = tuple(out)
        return xs[0] if len(xs) == 1 else xs


class _NoRegion:
    """:func:`region` with no profiler session: nothing is recorded and
    the tensors pass through untouched."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def input(*xs):
        return xs[0] if len(xs) == 1 else xs

    @staticmethod
    def output(*xs):
        return xs[0] if len(xs) == 1 else xs


_NO_REGION = _NoRegion()


def region(name: str):
    """A range named ``name`` around a differentiable region, and
    ``<name>.bwd`` around its backward.  Pass the region's inputs through
    ``.input(...)`` as it starts and its outputs through ``.output(...)``
    as it ends (each returns its arguments, one tensor bare)::

        with tracing.region("model.mlp") as r:
            h = mlp(r.input(x))
            h = r.output(h)

    Tensors that need no gradient, and None, pass through; with no
    profiler session, or with gradients off, every tensor does."""
    if enabled():
        return _Region(name)
    return _NO_REGION
