"""Serving driver: random prompts through the paged continuous-batching
engine (the reference's ``--mode batch``).

  # CPU smoke run, plain PyTorch paths:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mode batch \
      --device cpu

  # moba-340m at full width on the card, paged decode through the
  # CUDA kernel, from int8 page pools:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch moba-340m \
      --mode batch --attn-backend flash --kv-dtype int8

  # SNR-guided adaptive routing: per-head top_k calibrated at engine
  # build (or --route-policy profile:PATH to load a saved profile):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch moba-340m \
      --mode batch --attn-backend flash --route-policy snr:pfail=0.01

  # radix-tree prefix cache, prompts prefilled in chunks of 256 tokens:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --mode batch \
      --device cpu --prefix-cache --prefill-chunk 256
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import (ServingError,
                                           UnsupportedFeatureError)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _make_engine(cfg, params, ecfg: EngineConfig, shards: int,
                 device="cuda") -> Engine:
    """Single-host Engine; the reference's sharded fleet (``shards > 0``)
    is not ported yet."""
    if shards:
        raise UnsupportedFeatureError(
            "shards", "the sharded engine is not ported yet; ROADMAP.md "
                      "lists it after the remaining engine features")
    return Engine(cfg, params, ecfg, device=device)


def serve(arch: str, batch: int = 4, prompt_len: int = 64, gen: int = 32,
          smoke: bool = True, attn_backend: str = "reference",
          seed: int = 0, device="cuda", shards: int = 0,
          kv_dtype: str = "fp32", route_policy: str = "static",
          prefill_chunk: int = 0, prefix_cache: bool = False,
          swap_bytes: int = EngineConfig.swap_bytes) -> np.ndarray:
    """Decode ``gen`` greedy tokens for ``batch`` random prompts through
    the paged engine.  ``prefill_chunk``, ``prefix_cache`` and
    ``swap_bytes`` are the ``EngineConfig`` fields of those names.
    Returns int32 tokens of shape (batch, gen)."""
    dev = resolve_device(device)
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                           dtype=np.int32)
    eng = _make_engine(cfg, params, EngineConfig(
        max_seqs=batch, max_seq_len=_round_up(prompt_len + gen, 16),
        max_prefill_batch=min(batch, 4), attn_backend=attn_backend,
        prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
        kv_dtype=kv_dtype, route_policy=route_policy,
        swap_bytes=swap_bytes),
        shards, device=dev)
    if eng.route_profile is not None:
        print(eng.route_profile.summary())
    reqs = [eng.submit(prompts[i], max_new_tokens=gen)
            for i in range(batch)]
    eng.run()
    st = eng.stats
    print(f"engine: {st['prefill_tokens']} prefill tokens in "
          f"{st['prefill_s']:.2f}s; {st['decode_tokens']} decode tokens "
          f"in {st['decode_s']:.2f}s over {st['decode_steps']} steps "
          f"({st['decode_tokens'] / max(st['decode_s'], 1e-9):.1f} tok/s) "
          f"on {dev}")
    if prefix_cache:
        rate = st["prefix_hit_tokens"] / max(st["prefix_prompt_tokens"], 1)
        print(f"  prefix cache: hit rate {rate:.2f} "
              f"({st['prefix_hit_tokens']} tokens), "
              f"{st['cow_copies']} COW copies, "
              f"{st['tree_evictions']} tree evictions")
    return np.stack([np.asarray(r.out[:gen], np.int32) for r in reqs])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="moba-340m",
                    choices=sorted(configs.ARCHS))
    ap.add_argument("--mode", default="batch", choices=["batch"],
                    help="batch: synchronous engine run over random "
                         "prompts (the reference's stream/openloop/fixed "
                         "modes are not ported yet)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn-backend", default=None,
                    help="registered attention backend, optionally with "
                         "an option suffix (reference | xla | flash, "
                         "flash:grouped | flash:flat; default reference)")
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "int8", "fp8"],
                    help="K/V page-pool storage precision: quantized "
                         "pools store int8/fp8 payload with per-page "
                         "per-kv-head fp32 scales; centroids and routing "
                         "stay fp32.  Backends must declare the dtype in "
                         "Capabilities.kv_dtypes (reference is fp32-only)")
    ap.add_argument("--route-policy", default="static",
                    help="MoBA routing policy: 'static' (uniform top_k), "
                         "'snr:pfail=P' (SNR-calibrated per-layer/per-"
                         "head top_k targeting retrieval-failure budget "
                         "P, e.g. snr:pfail=0.01), or 'profile:PATH' "
                         "(load a saved routing-profile artifact); "
                         "core/adaptive.py")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: cache prompts in chunks of "
                         "this many tokens across engine steps "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix caching: requests sharing a "
                         "cached token prefix reuse its KV pages "
                         "(copy-on-write) and prefill only the suffix")
    ap.add_argument("--swap-bytes", type=int,
                    default=EngineConfig.swap_bytes,
                    help="host-memory budget for preemption swap "
                         "(bytes; 0 disables swap so preempted requests "
                         "recompute; default %(default)s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen, smoke=args.smoke,
              attn_backend=args.attn_backend or "reference",
              seed=args.seed, device=args.device, kv_dtype=args.kv_dtype,
              route_policy=args.route_policy,
              prefill_chunk=args.prefill_chunk,
              prefix_cache=args.prefix_cache, swap_bytes=args.swap_bytes)
    except ServingError as e:  # unsupported config / impossible sizing
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
