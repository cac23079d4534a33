"""Dry run: cost every (arch × shape × layout) cell of the production
layouts on placeholder devices, with no GPU, and emit the roofline terms
(``launch/roofline.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --archs qwen3-0.6b \\
      --shapes train_4k --mesh single

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``mesh`` is ``single`` or ``multi``).  Two passes per cell, as in the
reference's ``launch/dryrun.py``:

1. **Accounting.**  The whole step at the global batch, with no
   microbatching, runs on ``meta`` tensors (shapes, no storage) on the
   ``xla`` backend (plain PyTorch; the reference lowers ``sp_unrolled``,
   plain XLA math): ``make_train_step`` with AdamW and remat,
   ``make_prefill_step`` or ``make_decode_step`` (caches full to the
   shape's length).  Matmul FLOPs come from ``FlopCounterMode``; bytes
   from :class:`BytesCounter`, each op's input and output bytes (eager
   fuses nothing, so this is eager's traffic, not XLA's post-fusion
   count).  Both are divided by the devices.
2. **One device's share.**  State bytes exactly from the specs
   (``distributed/sharding.py``): params; for ``train`` fp32 grads and
   AdamW's ``mu``/``nu`` under the params' specs; caches under
   ``launch/steps.py::cache_specs``.  The activation peak comes from
   :class:`LiveBytes` over one microbatch's step at the per-device rows
   (global batch ÷ ``MICROBATCH`` ÷ the data-axis size where it divides,
   as ``batch_specs`` does) at full width, grads excluded (they are
   state).  When tensor parallelism is on it is divided by the ``model``
   axis size: an approximation, since sequence-length and routing
   tensors do not shard with the heads, and the layout's resharding
   buffers are not seen.  The reference's production pass lowers ``sp``;
   the port traces ``xla`` here too, since its ``sp`` backend drives
   every shard of a ``CPGroup`` from one host.

Collectives are not traced (one process, no mesh): :func:`collectives`
counts them per device from the schedule the specs imply, in the
reference's convention (each collective's result bytes, an all-reduce
twice).  Deep models are traced at one and at two periods of their
layer pattern and extrapolated linearly to the full depth
(:func:`_extrapolate`); ``tests/test_torch_dryrun.py`` holds the
extrapolation equal to the whole trace at smoke size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import defaultdict
from fractions import Fraction
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import (ASSIGNED_SHAPES, ModelConfig,
                                      ShardingConfig, TrainConfig)
from repro_torch.distributed import sharding as shmod
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import production_layout
from repro_torch.models import api, moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves

# gradient-accumulation factor for train_4k (global batch 256): keeps
# per-microbatch activations within device memory for the large archs.
# The accounting pass runs without accumulation — identical math.
MICROBATCH = {
    "llama-3.2-vision-90b": 16,
    "qwen3-14b": 8,
    "codeqwen1.5-7b": 8,
    "moonshot-v1-16b-a3b": 4,
    "qwen2-moe-a2.7b": 2,
    "internlm2-1.8b": 2,
    "zamba2-1.2b": 2,
    "mamba2-780m": 2,
}

BACKEND = "xla"
OUT = "experiments/dryrun_torch"


# ------------------------------------------------------------ dispatch modes
def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes through ``t``: its elements, but
    no more than its storage holds (an expanded view reads less)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class BytesCounter(TorchDispatchMode):
    """Sums every aten op's input and output bytes; view ops (which move
    nothing) are skipped."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.total += sum(_nbytes(t) for t in _tensors(out))
        return out


class LiveBytes(TorchDispatchMode):
    """Live bytes of the storages that ops create, each storage counted
    once (views included) from its first appearance until a weakref
    finalizer sees it freed.  ``mark(t)`` moves ``t``'s storage to the
    excluded share (a gradient: state, costed from the specs), and
    ``peak`` is the most that the rest ever held at once.  The peak is
    read before each op and each free, so a tensor marked as soon as it
    is made (a gradient hook) never counts."""

    def __init__(self):
        super().__init__()
        self.live = self.excluded = self.peak = 0
        self._seen: Dict[int, list] = {}

    def _update(self):
        self.peak = max(self.peak, self.live - self.excluded)

    def _free(self, key: int):
        self._update()
        nbytes, marked = self._seen.pop(key)
        self.live -= nbytes
        if marked:
            self.excluded -= nbytes

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key not in self._seen:
            self._seen[key] = [st.nbytes(), False]
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)

    def mark(self, t: torch.Tensor):
        rec = self._seen.get(id(t.untyped_storage()))
        if rec is not None and not rec[1]:
            rec[1] = True
            self.excluded += rec[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._update()
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._track(t)
        return out

    def __exit__(self, *exc):
        self._update()
        return super().__exit__(*exc)


# ------------------------------------------------------------------ a cell
def shape_name(shape) -> str:
    if isinstance(shape, str):
        return shape
    s, b, kind = shape
    return f"{kind}_{b}x{s}"


def _config(arch: str, block_size: int, top_k: int,
            key_conv_width: int) -> ModelConfig:
    """The arch's full config with MoBA on (the paper's own models take
    no ``moba`` switch: they are MoBA models)."""
    kw = dict(block_size=block_size, top_k=top_k,
              key_conv_width=key_conv_width)
    if not arch.startswith("moba-"):
        kw["moba"] = True
    return configs.get_config(arch, **kw)


def _with_groups(cfg: ModelConfig, groups: int) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=groups
                               * len(cfg.layer_pattern))


def meta_params(cfg: ModelConfig) -> dict:
    """fp32 params of ``init_lm``'s tree on the meta device."""
    def build(t):
        return ({k: build(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.empty(t, device="meta"))
    return build(T.param_shapes(cfg))


def _fill_caches(caches: dict, length: int):
    """Dense caches holding ``length`` positions (a decode's context)."""
    for v in caches.values():
        if isinstance(v, dict):
            _fill_caches(v, length)
    if "len" in caches:
        caches["len"] = length


def run_step(cfg: ModelConfig, shape, *, remat: bool = True,
             backend: str = BACKEND, device="meta", on_params=None):
    """One step of a cell on ``device``: ``make_train_step`` (AdamW,
    ``remat``, no accumulation) at the cell's batch, or
    ``make_prefill_step`` / ``make_decode_step`` (dense caches of the
    cell's length; a decode step's filled to length − 1).  Inputs and
    state are built before the step; ``on_params(params)`` runs between
    them and the step (the tracker hooks the gradients there)."""
    seq, batch, kind = api.shape_info(shape)
    dt = getattr(torch, cfg.dtype)
    params = (meta_params(cfg) if device == "meta" else
              T.init_lm(torch.Generator(device=device).manual_seed(0),
                        cfg))
    specs = api.input_specs(cfg, shape, dtype=dt, device=device)
    extras = {k: specs[k] for k in ("cross_kv", "src_embeds") if k in specs}
    if kind == "train":
        tcfg = TrainConfig(global_batch_size=batch, seq_len=seq)
        step = S.make_train_step(cfg, tcfg, backend=backend, remat=remat)
        args = (params, adamw.adamw_init(params),
                {"tokens": specs["tokens"], **extras})
        extras = {}
    elif kind == "prefill":
        step = S.make_prefill_step(cfg, backend=backend)
        args = (params, specs["tokens"],
                T.init_caches(cfg, batch, seq, dtype=dt, device=device))
    else:
        _fill_caches(specs["caches"], seq - 1)
        step = S.make_decode_step(cfg, backend=backend)
        args = (params, specs["token"], specs["caches"])
    if on_params is not None:
        on_params(params)
    return step(*args, **extras)


def count_step(cfg: ModelConfig, shape, remat: bool = True) -> dict:
    """Matmul FLOPs and op bytes of one step on meta tensors."""
    with FlopCounterMode(display=False) as fc, BytesCounter() as bc:
        run_step(cfg, shape, remat=remat)
    return {"flops": float(fc.get_total_flops()), "bytes": float(bc.total)}


def activation_peak(cfg: ModelConfig, shape, remat: bool = True) -> float:
    """The most bytes a step's own tensors hold at once on meta tensors,
    gradients excluded."""
    kind = api.shape_info(shape)[2]
    tracker = LiveBytes()

    def hook(params):
        for _, p in tree_leaves(params):
            p.requires_grad_()
            p.register_hook(tracker.mark)

    with tracker:
        run_step(cfg, shape, remat=remat,
                 on_params=hook if kind == "train" else None)
    return float(tracker.peak)


def _extrapolate(fn, cfg: ModelConfig, points, whole: bool = False):
    """``fn(cfg)`` (a dict of numbers, or a number) at the config's depth
    of n periods of its layer pattern: traced whole when ``whole`` or n ≤
    max(points), else traced at ``points`` periods and extended by the
    polynomial through them (exact rational weights).  Each period runs
    the same ops, so FLOPs grow linearly; op bytes grow quadratically
    (a stacked leaf's gradient is a full-stack ``select_backward`` per
    period), and three points give them exactly; the activation peak
    grows linearly once the period that sets it is the same (two points
    from the third period on).  ``tests/test_torch_dryrun.py`` holds each
    equal to the whole trace at smoke size."""
    n = cfg.num_layers // len(cfg.layer_pattern)
    if whole or n <= max(points):
        return fn(cfg)
    ys = [fn(_with_groups(cfg, g)) for g in points]
    w = [math.prod(Fraction(n - q, p - q) for q in points if q != p)
         for p in points]

    def at(vals):
        return float(sum(wi * Fraction(v) for wi, v in zip(w, vals)))
    if isinstance(ys[0], dict):
        return {k: at([y[k] for y in ys]) for k in ys[0]}
    return at(ys)


COUNT_POINTS = (1, 2, 3)        # periods traced for FLOPs and bytes
PEAK_POINTS = (3, 4)            # and for the activation peak


# --------------------------------------------------------------- the state
def state_bytes(cfg: ModelConfig, shape, layout: shmod.Layout,
                scfg: ShardingConfig) -> Dict[str, float]:
    """One device's state bytes, exactly from the specs: fp32 params;
    for ``train`` fp32 grads and AdamW's mu and nu under the params'
    specs; for prefill and decode the dense caches under
    ``cache_specs``."""
    seq, batch, kind = api.shape_info(shape)
    shapes = T.param_shapes(cfg)
    specs = shmod.param_specs(shapes, layout, scfg)
    p = sum(shmod.local_bytes(s, sp, layout, 4) for (_, s), (_, sp)
            in zip(tree_leaves(shapes), tree_leaves(specs)))
    out = {"params": float(p)}
    if kind == "train":
        out.update(grads=float(p), adam_mu=float(p), adam_nu=float(p))
        return out
    caches = T.init_caches(cfg, batch, seq, dtype=getattr(torch, cfg.dtype),
                           device="meta")
    cspecs = S.cache_specs(caches, cfg, layout, batch,
                           long_context=(kind == "decode"))
    out["caches"] = float(sum(
        shmod.local_bytes(c.shape, sp, layout, c.element_size())
        for (_, c), (_, sp) in zip(tree_leaves(caches), tree_leaves(cspecs))
        if isinstance(c, torch.Tensor)))
    return out


def device_rows(arch: str, shape, layout: shmod.Layout,
                microbatch: Optional[int] = None) -> int:
    """Rows one device steps at once: the global batch ÷ the microbatch
    count (train) ÷ the data-axis size where it divides."""
    _, batch, kind = api.shape_info(shape)
    m = (microbatch if microbatch is not None else MICROBATCH.get(arch, 0))
    rows = batch // m if kind == "train" and m and batch % m == 0 else batch
    dp = layout.axis_size(shmod.data_axes(layout))
    return rows // dp if rows % dp == 0 else rows


# ------------------------------------------------------------- collectives
def _has(spec_entry, axes) -> bool:
    names = (() if spec_entry is None else (spec_entry,)
             if isinstance(spec_entry, str) else spec_entry)
    return any(a in axes for a in names)


def collectives(cfg: ModelConfig, shape, layout: shmod.Layout,
                scfg: ShardingConfig, remat: bool = True
                ) -> Dict[str, Dict[str, float]]:
    """Per-device collective bytes by kind, then by tensor or parameter
    path, from the schedule the specs imply (result bytes; an all-reduce
    counted twice, as ``roofline._MULT``):

    * FSDP all-gathers each data-sharded weight in the compute dtype
      before use: once in the forward, again in the remat backward for
      weights inside the layer groups; the embedding, head and encoder
      sit outside them.
    * FSDP reduce-scatters each data-sharded fp32 gradient; a gradient
      replicated over the data axes is all-reduced.
    * TP all-reduces the outputs of ``wo``, ``w_down`` and ``out_proj``
      (each forward pass), and the input gradients of the
      column-parallel weights (``wq``/``wk``/``wv``, ``w_gate``/``w_up``,
      ``in_proj``) in the backward.
    * A vocabulary-parallel embedding all-reduces its lookup; vocabulary-
      parallel logits all-reduce the loss's max, sum and target logit a
      token and, in the backward, the head's input gradient (a decode
      step all-reduces its argmax).
    * EP all-to-alls each MoE layer's expert buffer (dispatch and
      combine; the transposes in the backward).
    * Sequence-sharded caches: a decode step all-reduces each attention
      layer's partial output and softmax statistics over the sequence
      axes; a prefill all-to-alls the K/V it writes into them."""
    seq, batch, kind = api.shape_info(shape)
    out: Dict[str, Dict[str, float]] = defaultdict(dict)

    def add(kind_, label, nbytes):
        if nbytes:
            out[kind_][label] = out[kind_].get(label, 0.0) + float(
                nbytes * RL._MULT[kind_])

    dt = getattr(torch, cfg.dtype).itemsize
    dax = shmod.data_axes(layout)
    n_data = layout.axis_size(dax)
    tp = ("model" if scfg.tensor_parallel and "model" in layout.axes
          else None)
    n_tp = layout.axis_size(tp)
    train = kind == "train"
    passes = 2 if train and remat else 1
    rows = batch // n_data if batch % n_data == 0 else batch
    tokens = rows * (1 if kind == "decode" else seq)
    act = tokens * cfg.d_model * dt

    shapes = T.param_shapes(cfg)
    specs = shmod.param_specs(shapes, layout, scfg)
    spec_of = dict(tree_leaves(specs))
    for path, shp in tree_leaves(shapes):
        spec = spec_of[path]
        sharded = n_data > 1 and any(_has(a, dax) for a in spec)
        if sharded:
            gathered = shmod.without_axes(spec, dax)
            inside = path.startswith(("blocks/", "shared/"))
            add("all-gather", path, (passes if inside else 1)
                * shmod.local_bytes(shp, gathered, layout, dt))
        if train and n_data > 1:
            local = shmod.local_bytes(shp, spec, layout, 4)
            add("reduce-scatter" if sharded else "all-reduce",
                path + " (grad)", local)

    if n_tp > 1:
        def tp_out(path):     # row-parallel: sharded on its input dim
            s = spec_of.get(path)
            return s is not None and len(s) >= 2 and _has(s[-2], (tp,))

        mem = (cfg.num_audio_frames if cfg.family == "encdec"
               else cfg.num_image_tokens)
        mem_act = rows * mem * cfg.d_model * dt
        # (param prefix, kind, layers, forward passes, activation bytes)
        pattern, n_groups = T._block_kinds(cfg)
        layers = [(f"blocks/slot_{i}", kind_, n_groups, passes, act)
                  for i, kind_ in enumerate(pattern)
                  if kind_ != "shared_attn"]
        if "shared" in shapes:
            layers.append(("shared", "dense", pattern.count("shared_attn")
                           * n_groups, passes, act))
        if cfg.num_encoder_layers:      # outside remat, over the frames
            layers.append(("encoder/blocks", T._encoder_kind(cfg),
                           cfg.num_encoder_layers, 1, mem_act))
        for prefix, kind_, count, fwd, x in layers:
            attn = [f"{prefix}/attn"] if kind_ != "ssm" else []
            if kind_ == "decoder":
                attn.append(f"{prefix}/cross")
            for a in attn:
                if tp_out(f"{a}/wo"):
                    add("all-reduce", f"{a}/wo out", count * fwd * x)
                    if train:
                        add("all-reduce", f"{a}/wq,wk,wv in grad",
                            count * x)
                        if a.endswith("/cross") and cfg.family == "encdec":
                            add("all-reduce", f"{a}/wk,wv memory grad",
                                count * mem_act)
            for m in (f"{prefix}/mlp", f"{prefix}/moe/shared"):
                if tp_out(f"{m}/w_down"):
                    add("all-reduce", f"{m}/w_down out", count * fwd * x)
                    if train:
                        add("all-reduce", f"{m}/w_gate,w_up in grad",
                            count * x)
            if tp_out(f"{prefix}/mamba/out_proj"):
                add("all-reduce", f"{prefix}/mamba/out_proj out",
                    count * fwd * x)
                if train:
                    add("all-reduce", f"{prefix}/mamba/in_proj in grad",
                        count * x)
            if (f"{prefix}/moe/experts/w_gate" in spec_of
                    and scfg.expert_parallel):
                e = cfg.moe.num_experts
                buf = (-(-e // n_tp) * moe.capacity(tokens, cfg)
                       * cfg.d_model * dt)
                add("all-to-all", f"{prefix}/moe expert buffers",
                    count * (2 * fwd + (2 if train else 0)) * buf)
        vocab_tp = _has((spec_of["embed"] + (None,))[0], (tp,))
        if vocab_tp:
            add("all-reduce", "embed lookup", act)
        head = spec_of.get("lm_head")
        head_tp = (vocab_tp if head is None
                   else len(head) == 2 and _has(head[1], (tp,)))
        if head_tp and train:
            add("all-reduce", "logits max, sum, target", 3 * tokens * 4)
            add("all-reduce", "head in grad", act)
        elif head_tp and kind == "decode":
            add("all-reduce", "logits argmax", rows * 8)

    if kind != "train":
        caches = T.init_caches(cfg, batch, seq,
                               dtype=getattr(torch, cfg.dtype),
                               device="meta")
        cspecs = dict(tree_leaves(S.cache_specs(
            caches, cfg, layout, batch, long_context=(kind == "decode"))))
        h, dh = cfg.num_heads, cfg.resolved_head_dim
        for path, c in tree_leaves(caches):
            sp = cspecs[path]
            if not path.endswith("/k") or layout.axis_size(sp[3]) == 1:
                continue
            slot = path[:-len("/k")]
            groups = c.shape[0]
            if kind == "decode":
                add("all-reduce", f"{slot} partial attention",
                    groups * rows * h * (dh + 2) * 4)
            else:
                add("all-to-all", f"{slot} K/V writes",
                    2 * shmod.local_bytes(c.shape, sp, layout,
                                          c.element_size()))
    return dict(out)


# ------------------------------------------------------------------ costing
def cost_cell(arch: str, shape, layout: Optional[shmod.Layout] = None, *,
              block_size: int = 128, top_k: int = 8,
              key_conv_width: int = 0, remat: bool = True,
              scfg: Optional[ShardingConfig] = None,
              microbatch: Optional[int] = None, accounting: bool = True,
              cfg: Optional[ModelConfig] = None,
              whole: bool = False, verbose: bool = True
              ) -> RL.Roofline:
    """Both passes of one cell on ``layout`` (the single production
    layout by default; a 1 × 1 layout costs one device's whole step).
    ``shape`` is an ``ASSIGNED_SHAPES`` name or a ``(seq_len,
    global_batch, kind)`` triple; ``cfg`` overrides the arch's config;
    ``whole`` traces the whole depth instead of extrapolating
    (:func:`_extrapolate`).  The record's ``detail`` holds the state by
    part, the activation peak, the collectives by tensor and the trace
    seconds."""
    layout = layout or production_layout()
    scfg = scfg or ShardingConfig()
    cfg = cfg or _config(arch, block_size, top_k, key_conv_width)
    seq, batch, kind = api.shape_info(shape)
    name = shape_name(shape)
    chips = layout.size
    t0 = time.perf_counter()
    counts = {"flops": 0.0, "bytes": 0.0}
    if accounting:
        counts = _extrapolate(lambda c: count_step(c, shape, remat), cfg,
                              COUNT_POINTS, whole)
    t_count = time.perf_counter() - t0
    m = MICROBATCH.get(arch, 0) if microbatch is None else microbatch
    rows = device_rows(arch, shape, layout, m)
    t0 = time.perf_counter()
    act = _extrapolate(lambda c: activation_peak(c, (seq, rows, kind),
                                                 remat), cfg, PEAK_POINTS,
                       whole)
    t_act = time.perf_counter() - t0
    n_tp = layout.axis_size("model" if scfg.tensor_parallel
                            and "model" in layout.axes else None)
    act_dev = act / n_tp
    state = state_bytes(cfg, shape, layout, scfg)
    coll = collectives(cfg, shape, layout, scfg, remat)
    by_kind = {k: sum(v.values()) for k, v in coll.items()}
    rl = RL.Roofline(
        arch=arch, shape=name, mesh=layout.name, chips=chips,
        flops_per_device=counts["flops"] / chips,
        bytes_per_device=counts["bytes"] / chips,
        coll_bytes_per_device=float(sum(by_kind.values())),
        coll_breakdown=by_kind, model_flops=S.model_flops(cfg, shape),
        peak_memory_bytes=float(sum(state.values()) + act_dev),
        detail={"state_bytes": state, "activation_peak_traced": act,
                "activation_peak_per_device": act_dev, "rows": rows,
                "microbatch": m if kind == "train" else 0,
                "collectives": coll, "backend": BACKEND, "remat": remat,
                "whole_depth": whole, "layout": list(layout.axes),
                "sharding": dataclasses.asdict(scfg),
                "seconds": {"accounting": t_count, "activations": t_act}})
    if verbose:
        print(f"[{arch} × {name} × {layout.name}] traced in "
              f"{t_count:.1f} + {t_act:.1f} s")
        print("  state/dev: " + " ".join(
            f"{k}={v / 1e9:.2f}GB" for k, v in state.items())
            + f" activations={act_dev / 1e9:.2f}GB (rows {rows})")
        print(f"  flops/dev={rl.flops_per_device:.3e}"
              f" bytes/dev={rl.bytes_per_device:.3e}")
        print("  collectives/dev: "
              + str({k: f"{v / 1e6:.1f}MB" for k, v in by_kind.items()}))
        print(f"  terms: compute={rl.t_compute:.3e}s memory={rl.t_memory:.3e}s"
              f" collective={rl.t_collective:.3e}s -> {rl.bottleneck}-bound,"
              f" useful={rl.useful_flops_ratio:.2f},"
              f" roofline={100 * rl.roofline_fraction:.1f}%")
    return rl


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Cost every assigned arch × shape on the production "
                    "layouts on meta tensors (no GPU) against an H100 "
                    "roofline.")
    ap.add_argument("--archs", default="all")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--key-conv", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--stop-on-error", action="store_true")
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--no-accounting", action="store_true",
                    help="skip the FLOP-accounting pass (the multi-pod "
                         "layout never runs it; the roofline table is "
                         "single-pod only)")
    args = ap.parse_args(argv)

    archs = (configs.ASSIGNED if args.archs == "all"
             else args.archs.split(","))
    shapes = (list(ASSIGNED_SHAPES) if args.shapes == "all"
              else args.shapes.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    rows, failures = [], []
    t_start = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag} (exists)")
                    continue
                try:
                    rl = cost_cell(arch, shape, production_layout(
                                       multi_pod=mp),
                                   block_size=args.block_size,
                                   top_k=args.top_k,
                                   key_conv_width=args.key_conv,
                                   accounting=not (args.no_accounting
                                                   or mp))
                    rows.append(rl)
                    with open(path, "w") as f:
                        json.dump(rl.to_dict(), f, indent=1)
                except Exception as e:     # report the cell, go on
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}")
                    traceback.print_exc()
                    if args.stop_on_error:
                        raise

    print()
    print(RL.format_table(rows))
    print(f"\nwall {time.perf_counter() - t_start:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print(f"\nall {len(rows)} cells costed OK")


if __name__ == "__main__":
    main()
