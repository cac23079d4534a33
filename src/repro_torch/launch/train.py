"""Training driver: synthetic data through ``make_train_step``.

  # CPU smoke run, plain PyTorch paths:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
      --device cpu

  # moba-340m at full width on the card, MoBA layers through the four
  # FlashMoBA CUDA kernels (fits without remat at this length):
  PYTHONPATH=src python -m repro_torch.launch.train --arch moba-340m \
      --seq 4096 --batch 1 --attn-backend flash

  # the paper's key convolution (kconv3) on the MoBA layers:
  PYTHONPATH=src python -m repro_torch.launch.train --arch moba-340m \
      --seq 4096 --batch 1 --attn-backend flash --key-conv 3

``--key-conv W`` also applies to ``--smoke`` configs with MoBA layers
(the JAX package's ``launch/train.py`` drops it there), so a CPU smoke
run trains the conv weights.  The reference's checkpoint/auto-resume
(``--ckpt-dir``, ``--resume``) and gradient accumulation
(``--microbatch``) are not ported yet: they raise
``UnsupportedFeatureError`` (ROADMAP.md §A).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import backends as B
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.monitor import HeartbeatMonitor
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serving.scheduler import (ServingError,
                                           UnsupportedFeatureError)


def _check_scope(ckpt_dir: str, resume: str, microbatch: int) -> None:
    if ckpt_dir or resume != "none":
        raise UnsupportedFeatureError(
            "ckpt_dir/resume", "checkpointing (the reference's "
                               "CheckpointManager) is not ported yet; see "
                               "ROADMAP.md §A")
    if microbatch > 1:
        raise UnsupportedFeatureError(
            "microbatch", "gradient accumulation is not ported yet; see "
                          "ROADMAP.md §A")


def _smoke_config(arch: str, key_conv_width: int):
    """``arch``'s smoke config, with key conv of ``key_conv_width`` on its
    MoBA layers when nonzero."""
    cfg = configs.get_smoke_config(arch)
    if not key_conv_width:
        return cfg
    a = cfg.attention
    if a.moba is None:
        raise UnsupportedFeatureError(
            "key_conv_width", f"{arch}'s smoke config has no MoBA layers "
                              f"to convolve keys for")
    moba = dataclasses.replace(a.moba, key_conv_width=key_conv_width)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        a, moba=moba))


def train(arch: str, steps: int = 50, batch: int = 8, seq: int = 512,
          smoke: bool = True, attn_backend: str = "sparse",
          ckpt_dir: str = "", resume: str = "none",
          lr: float = 6e-4, seed: int = 0,
          microbatch: int = 0, log_every: int = 10,
          block_size: int = 0, top_k: int = 0, key_conv_width: int = 0,
          remat: bool = False, on_step=None, stop_at_step: int = 0,
          total_steps_override: int = 0, device="cuda"):
    """Train ``arch`` on synthetic data for ``steps`` steps; returns
    (params, losses).  ``device`` defaults to the card and raises without
    one; pass "cpu" for the plain PyTorch paths."""
    _check_scope(ckpt_dir, resume, microbatch)
    dev = resolve_device(device)
    kw = {}
    if block_size:
        kw["block_size"] = block_size
    if top_k:
        kw["top_k"] = top_k
    if key_conv_width:
        kw["key_conv_width"] = key_conv_width
    cfg = (_smoke_config(arch, key_conv_width) if smoke
           else configs.get_config(arch, **kw))
    horizon = total_steps_override or steps
    tcfg = TrainConfig(global_batch_size=batch, seq_len=seq,
                       learning_rate=lr, total_steps=horizon,
                       warmup_steps=max(horizon // 10, 1), seed=seed,
                       microbatch=microbatch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    params = T.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_state = adamw.adamw_init(params)
    # full spec strings allowed, e.g. "flash:flat,kb_tile=64" — options
    # apply process-wide to the named backend instance
    backend = B.resolve_backend_spec(attn_backend, default="sparse")
    step_fn = S.make_train_step(cfg, tcfg, backend=backend, remat=remat)

    losses = []
    t0 = time.time()
    monitor = HeartbeatMonitor(
        on_straggler=lambda st, dt, med: print(
            f"[monitor] straggler step {st}: {dt:.2f}s vs median "
            f"{med:.2f}s"))
    end = min(stop_at_step, steps) if stop_at_step else steps
    for step in range(end):
        tokens = torch.as_tensor(data.batch_at(step)["tokens"], device=dev)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             {"tokens": tokens})
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.beat(step)
        if on_step:
            on_step(step, loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"[{time.time() - t0:6.1f}s]", flush=True)
    if monitor.straggler_steps:
        print(f"[monitor] summary: {monitor.summary()}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="moba-340m",
                    choices=sorted(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--attn-backend", default="sparse",
                    help="backend spec, e.g. sparse | flash | flash:flat | "
                         "flash:grouped,kb_tile=64")
    ap.add_argument("--ckpt-dir", default="",
                    help="not ported yet: raises")
    ap.add_argument("--resume", default="none", choices=["none", "auto"],
                    help="not ported yet: 'auto' raises")
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="not ported yet: values above 1 raise")
    ap.add_argument("--block-size", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--key-conv", type=int, default=0,
                    help="key-conv width on the MoBA layers (0 = off; the "
                         "paper's kconv3/kconv5)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
              smoke=args.smoke, attn_backend=args.attn_backend,
              ckpt_dir=args.ckpt_dir, resume=args.resume,
              lr=args.lr, seed=args.seed,
              microbatch=args.microbatch, block_size=args.block_size,
              top_k=args.top_k, key_conv_width=args.key_conv,
              device=args.device)
    except ServingError as e:  # out-of-scope flag
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
