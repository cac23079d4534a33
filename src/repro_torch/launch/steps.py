"""Step-function builders: the training step, the fixed serving loop's
dense-cache prefill and decode steps, and the paged serving engine's;
``model_flops``, the model FLOPs of one assigned shape; ``batch_specs``
and ``cache_specs``, where a production layout places a cell's batch and
caches (``distributed/sharding.py``'s specs; the dry run costs them).

The reference jits these and donates the params, optimizer state and
cache arguments; the port runs them eagerly and updates params, moments
and pools in place, so the returned trees are the ones passed in.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import sharding as shmod
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    backend: str = "sparse", remat: bool = True,
                    accum_in_loss: bool = False,
                    state: Optional[dict] = None):
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, {'loss', 'lr', 'grad_norm'})`` with ``batch``
    {'tokens': (B, S+1)} and, for the vision and encoder-decoder
    families, 'cross_kv' or 'src_embeds' (B, M, d_model).  Gradients
    come from torch autograd through :func:`repro_torch.models.
    transformer.lm_loss` (``remat`` checkpoints each layer group), then
    one :func:`repro_torch.optim.adamw.adamw_update`.

    Gradient accumulation, as in the reference: ``tcfg.microbatch`` m > 1
    splits every entry of the batch along dim 0 into m chunks of B/m rows
    (chunk i holds rows [i·B/m, (i+1)·B/m), the reference's reshape) and
    runs one backward a chunk, summing the fp32 gradients with weight
    1/m.  With ``accum_in_loss`` the loss is instead the 1/m-weighted sum
    over the chunks, each chunk's loss under ``torch.utils.checkpoint``
    (only its inputs are kept; the backward recomputes it), and one
    ``autograd.grad`` differentiates the whole; the reference expresses
    this as a scan over rematted chunks so the gradient reduction happens
    once a step.  Either way one chunk's activations are live at a time
    and the loss is the mean of the chunks' losses.

    A ``LatentMoEConfig`` model trains with its routing ``state``
    (``transformer.init_router_state``, updated in place): the step moves
    the routing bias after the optimizer and returns the step's
    per-expert pair counts as ``expert_counts``; when a layer's held
    pairs outgrew their bounded buffer it takes its gradients again over
    every pair first (``retaken``; ``transformer.train_functions``;
    chosen here, once)."""
    lr_fn = adamw.cosine_schedule(tcfg)
    m = tcfg.microbatch if tcfg.microbatch and tcfg.microbatch > 1 else 1
    loss_fn, retake, after_step = T.train_functions(cfg, state)

    def chunk_loss(params, chunk):
        return loss_fn(params, chunk, cfg, backend=backend,
                       remat=remat)[0]

    def chunks(batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % m:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{m} microbatches")
        split = {k: v.reshape(m, rows // m, *v.shape[1:])
                 for k, v in batch.items()}
        return [{k: v[i] for k, v in split.items()} for i in range(m)]

    def train_step(params, opt_state, batch):
        with tracing.span("train.step"):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        leaves = [leaf.requires_grad_() for _, leaf in
                  adamw.tree_leaves(params)]
        loss, grads = gradients(params, leaves, batch)
        if retake is not None and retake():
            del loss, grads
            loss, grads = gradients(params, leaves, batch)
        grads = adamw.tree_like(params, grads)
        with tracing.span("train.optimizer"):
            params, opt_state, om = adamw.adamw_update(
                params, grads, opt_state, tcfg, lr_fn)
        out = {"loss": loss.detach()}
        out.update(om)
        if after_step is not None:
            after_step(out)
        return params, opt_state, out

    def gradients(params, leaves, batch):
        if m == 1:
            with tracing.span("train.forward"):
                loss = chunk_loss(params, batch)
            with tracing.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
        elif accum_in_loss:
            loss = torch.zeros((), device=leaves[0].device)
            for c in chunks(batch):
                with tracing.span("train.forward"):
                    loss = loss + torch.utils.checkpoint.checkpoint(
                        chunk_loss, params, c, use_reentrant=False) / m
            with tracing.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
        else:
            loss = torch.zeros((), device=leaves[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            for c in chunks(batch):
                with tracing.span("train.forward"):
                    lc = chunk_loss(params, c)
                with tracing.span("train.backward"):
                    gc = torch.autograd.grad(lc, leaves)
                    loss = loss + lc.detach() / m
                    grads = [a + g / m for a, g in zip(grads, gc)]
        return loss, grads

    return train_step


def stub_frontend_inputs(cfg: ModelConfig, rng: np.random.Generator,
                         batch: int, device) -> Dict[str, torch.Tensor]:
    """The stub frontends' inputs, drawn as the reference's entry points
    draw them: N(0, 1) image embeddings ``cross_kv`` (batch,
    num_image_tokens, d_model) for the ``vlm`` family, frame embeddings
    ``src_embeds`` (batch, num_audio_frames, d_model) for ``encdec``, in
    ``cfg.dtype``; nothing for the other families."""
    dt = getattr(torch, cfg.dtype)
    extras = {}
    if cfg.family == "vlm":
        extras["cross_kv"] = torch.as_tensor(rng.normal(
            0, 1, (batch, cfg.num_image_tokens, cfg.d_model)), dtype=dt,
            device=device)
    if cfg.family == "encdec":
        extras["src_embeds"] = torch.as_tensor(rng.normal(
            0, 1, (batch, cfg.num_audio_frames, cfg.d_model)), dtype=dt,
            device=device)
    return extras


def _cross_kv(params, cfg: ModelConfig, backend: str, cross_kv,
              src_embeds):
    """The cross-attention memory of a step: the encoder's output over
    ``src_embeds`` for an encoder-decoder model given them, else
    ``cross_kv`` (image embeddings, or None)."""
    if cfg.num_encoder_layers and src_embeds is not None:
        return T.apply_encoder(params, src_embeds, cfg, backend=backend)
    return cross_kv


def make_prefill_step(cfg: ModelConfig, backend: str = "sparse"):
    """Dense-cache prefill: ``prefill_step(params, tokens (B, S), caches,
    cross_kv=None, src_embeds=None) -> (logits of the last position (B, 1,
    V), caches)``.  An encoder-decoder model runs its encoder over
    ``src_embeds`` first, and the decoder attends onto its output."""

    @torch.no_grad()
    def prefill_step(params, tokens, caches, cross_kv=None,
                     src_embeds=None):
        ck = _cross_kv(params, cfg, backend, cross_kv, src_embeds)
        logits, caches = T.prefill(params, tokens, cfg, caches,
                                   backend=backend, cross_kv=ck)
        return logits[:, -1:], caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, backend: str = "reference"):
    """Dense-cache greedy decode: ``decode_step(params, token (B, 1),
    caches, cross_kv=None, src_embeds=None) -> (next token (B, 1) int32,
    caches)``.  As in the reference, the stub encoder runs again over
    ``src_embeds`` in every step (its output is not cached), and cross
    attention projects its K/V from the memory in every step."""

    @torch.no_grad()
    def decode_step(params, token, caches, cross_kv=None, src_embeds=None):
        ck = _cross_kv(params, cfg, backend, cross_kv, src_embeds)
        logits, caches = T.decode_step(params, token, cfg, caches,
                                       backend=backend, cross_kv=ck)
        next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return next_tok.to(torch.int32), caches

    return decode_step


def as_route_map(route_map, device=None
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """A routing profile's ``{"slot_i": (n_groups, H)}`` head budgets as
    contiguous int32 tensors (on ``device``; None keeps a tensor's own
    device).  The engine converts once, at build: a step then reads a
    budget row as a view, so it uploads, casts and launches nothing for
    it."""
    if route_map is None:
        return None
    return {k: torch.as_tensor(v, dtype=torch.int32,
                               device=device).contiguous()
            for k, v in route_map.items()}


def make_paged_prefill_step(cfg: ModelConfig, backend: str = "reference",
                            chunked: bool = False, route_map=None):
    """Ragged prefill into a paged cache: tokens (B, L) right-padded with
    per-row valid length ``q_len``; rows with q_len == 0 are padding.
    ``kv_len`` gives each row's pre-step cache length (all zeros for
    one-shot prefill; chunk offsets under chunked prefill).  ``slots``
    maps prefill rows to scheduler sequence slots (kept for the
    reference's signature; only its key-conv ring buffers read it).
    ``chunked=True`` selects the chunk-aware attention path that sees
    earlier chunks through the block table.  ``route_map`` carries an
    adaptive routing profile's per-head top_k budgets (None = static; see
    :func:`as_route_map`).  Returns (sampled next token (B,) — meaningful
    only for rows whose prompt is now fully cached, caches)."""
    rmap = as_route_map(route_map)

    @torch.no_grad()
    def prefill_step(params, tokens, caches, block_table, kv_len, q_len,
                     slots, active):
        page_state = {"block_table": block_table, "kv_len": kv_len,
                      "q_len": q_len, "slots": slots, "active": active,
                      "chunked": chunked}
        positions = (kv_len[:, None] + torch.arange(tokens.shape[1],
                                                    device=tokens.device)
                     if chunked else None)
        logits, caches = T.prefill(params, tokens, cfg, caches,
                                   backend=backend, page_state=page_state,
                                   positions=positions, route_map=rmap)
        last = torch.clamp(q_len - 1, min=0).long()          # (B,)
        lg = logits[torch.arange(tokens.shape[0],
                                 device=tokens.device), last]  # (B,V)
        return torch.argmax(lg, dim=-1).to(torch.int32), caches

    return prefill_step


def make_paged_decode_step(cfg: ModelConfig, backend: str = "reference",
                           route_map=None):
    """One continuous-batching decode step over all sequence slots:
    token (B,), per-slot pre-step lengths kv_len (B,), active mask (B,).
    ``route_map`` as in :func:`make_paged_prefill_step`.  Returns (next
    token (B,), caches)."""
    rmap = as_route_map(route_map)

    @torch.no_grad()
    def decode_step(params, token, caches, block_table, kv_len, active):
        page_state = {"block_table": block_table, "kv_len": kv_len,
                      "q_len": active.to(torch.int32), "active": active}
        logits, caches = T.decode_step(params, token[:, None], cfg,
                                       caches, backend=backend,
                                       page_state=page_state,
                                       route_map=rmap)
        return (torch.argmax(logits[:, -1], dim=-1).to(torch.int32),
                caches)

    return decode_step


def model_flops(cfg: ModelConfig, shape) -> float:
    """MODEL_FLOPS of one cell (an ``ASSIGNED_SHAPES`` name or a
    ``(seq_len, global_batch, kind)`` triple): 6·N·D (train) / 2·N·D
    (forward) with N the active parameters less an untied embedding
    table (a lookup, ~no matmul; MoE: only routed top-k + shared
    experts) and D the tokens (decode: one a sequence)."""
    seq, batch, kind = api.shape_info(shape)
    n = api.active_param_count(cfg)
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model
    if kind == "train":
        return 6.0 * n * seq * batch
    if kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch


# -------------------------------------------------------------- shardings
def _batch_axes(layout: shmod.Layout, batch: int):
    """The data axes when ``batch`` rows split over them, else None."""
    dp = shmod.data_axes(layout)
    return dp if batch % layout.axis_size(dp) == 0 else None


def batch_specs(cfg: ModelConfig, layout: shmod.Layout, batch: int) -> Dict:
    """Specs of a cell's batch inputs (the reference's
    ``batch_shardings``): rows over the data axes where they divide."""
    bspec = _batch_axes(layout, batch)
    tok = shmod.as_spec(bspec, None)
    out = {"tokens": tok, "token": tok}
    if cfg.family == "vlm":
        out["cross_kv"] = shmod.as_spec(bspec, None, None)
    if cfg.family == "encdec":
        out["src_embeds"] = shmod.as_spec(bspec, None, None)
    return out


def cache_specs(caches: dict, cfg: ModelConfig, layout: shmod.Layout,
                batch: int, long_context: bool = False) -> dict:
    """Leaf-name-driven cache specs (the reference's ``cache_shardings``),
    a tree of ``caches``' structure: K/V and centroids hold the sequence
    over ``model``; long context (a batch that does not split) holds it
    over every axis (context parallelism).  A host-int ``len`` is
    replicated, ``()``."""
    bspec = _batch_axes(layout, batch)
    seq_axes = (shmod.data_axes(layout) + ("model",)
                if long_context and bspec is None else "model")

    def spec_of(name):
        if name in ("k", "v", "centroids"):   # leading group dim
            return shmod.as_spec(None, bspec, None, seq_axes, None)
        if name == "ssm":
            return shmod.as_spec(None, bspec, "model", None, None)
        if name == "conv":
            return shmod.as_spec(None, bspec, None, "model")
        if name == "key_conv_state":
            return shmod.as_spec(None, bspec, None, None, None)
        return ()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec_of(k)
                for k, v in tree.items()}
    return walk(caches)
