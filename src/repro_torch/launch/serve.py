"""Serving driver: the paged continuous-batching engine under four load
shapes, and the fixed-batch loop over dense per-sequence caches.

  # CPU smoke run (default --mode stream: Poisson arrivals, p50/p99
  # time to first token and latency), plain PyTorch paths:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

  # open-loop arrivals (one every 4 decode steps) over the staged API:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --mode openloop --requests 8

  # the legacy fixed-batch loop (dense caches, lockstep greedy decode):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --mode fixed --batch 3 --prompt-len 33 --gen 8

  # an HTTP front end: POST /generate streams JSON-lines tokens,
  # GET /stats returns the engine's counters; Ctrl-C stops it:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --http 8000

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

  # the sharded engine: 2 page-pool shards (one a card, cuda:0 and
  # cuda:1; with --device cpu both on the CPU), --max-seqs and
  # --num-pages per shard, per-shard counts in the report:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --shards 2

On the card every kernel builds with ``nvcc`` at its first launch, so a
cold process's first prefill (and with it the first request's time to
first token) includes the build, as the reference's includes its jit
compile.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineConfig, engine_supported
from repro_torch.serving.scheduler import (ServingError,
                                           UnsupportedFeatureError)
from repro_torch.serving.sharded import ShardedEngine


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _make_engine(cfg, params, ecfg: EngineConfig, shards: int,
                 device="cuda"):
    """Single-device Engine (shards == 0) or the sharded fleet, whose
    ``ecfg`` sizes are per shard.  On CUDA shard i goes to ``cuda:i``
    (more shards than cards raises); on the CPU every shard is on it."""
    if shards:
        dev = torch.device(device)
        return ShardedEngine(cfg, params, ecfg, n_shards=shards,
                             devices=None if dev.type == "cuda"
                             else [dev] * shards)
    return Engine(cfg, params, ecfg, device=device)


def _shard_report(eng, metrics: dict) -> None:
    """Per-shard decode tokens/s and request counts of a sharded
    engine into ``metrics``, as the reference's stream mode reports."""
    dec_s = max(eng.stats["decode_s"], 1e-9)
    metrics["per_shard_tokens_per_s"] = [
        st["decode_tokens"] / dec_s for st in eng.shard_stats]
    metrics["per_shard_requests"] = [st["requests"]
                                     for st in eng.shard_stats]
    for s, tps in enumerate(metrics["per_shard_tokens_per_s"]):
        print(f"  shard {s}: {metrics['per_shard_requests'][s]} "
              f"requests, {tps:.1f} tok/s")


def _model(arch: str, smoke: bool, seed: int, device):
    """(config, seeded random params) on ``device``."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    return cfg, T.init_lm(torch.Generator(device=device).manual_seed(seed),
                          cfg)


# the paged engine's options with their defaults: the fixed-batch loop
# keeps dense per-sequence caches and refuses any of them set otherwise
_ENGINE_ONLY = dict(shards=0, kv_dtype="fp32", route_policy="static",
                    prefill_chunk=0, prefix_cache=False,
                    swap_bytes=EngineConfig.swap_bytes)


def serve(arch: str, batch: int = 4, prompt_len: int = 64, gen: int = 32,
          smoke: bool = True, attn_backend: str = "reference",
          seed: int = 0, use_engine: str = "auto", device="cuda",
          shards: int = 0, kv_dtype: str = "fp32",
          route_policy: str = "static", prefill_chunk: int = 0,
          prefix_cache: bool = False,
          swap_bytes: int = EngineConfig.swap_bytes) -> np.ndarray:
    """Decode ``gen`` greedy tokens for ``batch`` random prompts.

    Routes through the paged engine when the config supports it
    (``use_engine='auto'``); otherwise, or with ``use_engine='never'``,
    through the fixed-batch loop (:func:`serve_fixed`).
    ``prefill_chunk``, ``prefix_cache`` and ``swap_bytes`` are the
    ``EngineConfig`` fields of those names; the fixed loop raises
    ``UnsupportedFeatureError`` for any engine option away from its
    default.  Returns int32 tokens of shape (batch, gen) either way."""
    dev = resolve_device(device)
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    if use_engine == "never" or (use_engine == "auto"
                                 and not engine_supported(cfg)):
        given = dict(shards=shards, kv_dtype=kv_dtype,
                     route_policy=route_policy, prefill_chunk=prefill_chunk,
                     prefix_cache=prefix_cache, swap_bytes=swap_bytes)
        moved = [k for k, v in given.items() if v != _ENGINE_ONLY[k]]
        if moved:
            raise UnsupportedFeatureError(
                moved[0], f"{', '.join(moved)} apply to the paged engine "
                          f"only; the fixed-batch loop keeps dense "
                          f"{cfg.dtype} per-sequence caches")
        return serve_fixed(arch, batch=batch, prompt_len=prompt_len,
                           gen=gen, smoke=smoke, attn_backend=attn_backend,
                           seed=seed, device=dev)
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


def serve_stream(arch: str, n_requests: int = 16, rate: float = 8.0,
                 prompt_range=(16, 96), gen_range=(8, 48),
                 max_seqs: int = 8, num_pages: int = 0,
                 smoke: bool = True, attn_backend: str = "reference",
                 seed: int = 0, realtime: bool = True,
                 prefill_chunk: int = 0, shards: int = 0,
                 prefix_cache: bool = False,
                 swap_bytes: int = EngineConfig.swap_bytes,
                 kv_dtype: str = "fp32", route_policy: str = "static",
                 device="cuda") -> dict:
    """Continuous-batching scenario: Poisson arrivals (``rate`` req/s),
    mixed prompt/generation lengths.  Reports tokens/s and p50/p99
    time-to-first-token + end-to-end latency (per shard too when
    ``shards > 0``).

    ``realtime=False`` collapses the arrival process (every request is
    queued at t=0) so percentiles stay meaningful as queueing-free
    engine latencies — honouring fictional arrivals against a free-
    running clock would make them negative."""
    dev = resolve_device(device)
    cfg, params = _model(arch, smoke, seed, dev)
    rng = np.random.default_rng(seed)
    max_len = _round_up(prompt_range[1] + gen_range[1], 16)
    eng = _make_engine(cfg, params, EngineConfig(
        max_seqs=max_seqs, max_seq_len=max_len, num_pages=num_pages,
        attn_backend=attn_backend, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache, kv_dtype=kv_dtype,
        route_policy=route_policy, swap_bytes=swap_bytes), shards,
        device=dev)
    t = 0.0
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.integers(*prompt_range))
        glen = int(rng.integers(*gen_range))
        eng.submit(rng.integers(0, cfg.vocab_size, plen, dtype=np.int32),
                   max_new_tokens=glen,
                   arrival=t if realtime else 0.0)
    t0 = time.perf_counter()
    done = eng.run(realtime=realtime)
    wall = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    ttft = np.array([r.t_first - r.arrival for r in done])
    lat = np.array([r.t_done - r.arrival for r in done])
    metrics = {
        "requests": len(done), "wall_s": wall,
        "generated_tokens": total_tokens,
        "tokens_per_s": total_tokens / max(wall, 1e-9),
        "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
        "ttft_p99_ms": float(np.percentile(ttft, 99) * 1e3),
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "preemptions": eng.stats["preemptions"],
        "decode_steps": eng.stats["decode_steps"],
    }
    if prefix_cache:
        st = eng.stats
        metrics["prefix_hit_rate"] = (
            st["prefix_hit_tokens"] / max(st["prefix_prompt_tokens"], 1))
        metrics["prefix_hit_tokens"] = st["prefix_hit_tokens"]
        metrics["cow_copies"] = st["cow_copies"]
        metrics["tree_evictions"] = st["tree_evictions"]
        metrics["swap_restores"] = st["swap_restores"]
        metrics["pages_in_use_peak"] = st["pages_in_use_peak"]
    print(f"stream: {metrics['requests']} requests, "
          f"{metrics['generated_tokens']} tokens in {wall:.2f}s "
          f"({metrics['tokens_per_s']:.1f} tok/s); "
          f"ttft p50/p99 {metrics['ttft_p50_ms']:.0f}/"
          f"{metrics['ttft_p99_ms']:.0f} ms; "
          f"latency p50/p99 {metrics['latency_p50_ms']:.0f}/"
          f"{metrics['latency_p99_ms']:.0f} ms; "
          f"{metrics['preemptions']} preemptions")
    if prefix_cache:
        print(f"  prefix cache: hit rate {metrics['prefix_hit_rate']:.2f} "
              f"({metrics['prefix_hit_tokens']} tokens), "
              f"{metrics['cow_copies']} COW copies, "
              f"{metrics['tree_evictions']} evictions, "
              f"{metrics['swap_restores']} swap restores, "
              f"peak {metrics['pages_in_use_peak']} pages")
    if shards:
        _shard_report(eng, metrics)
    return metrics


def serve_openloop(arch: str, n_requests: int = 16, every: int = 4,
                   prompt_range=(16, 96), gen_range=(8, 48),
                   max_seqs: int = 8, num_pages: int = 0,
                   smoke: bool = True, attn_backend: str = "reference",
                   seed: int = 0, prefill_chunk: int = 0,
                   shards: int = 0, prefix_cache: bool = False,
                   swap_bytes: int = EngineConfig.swap_bytes,
                   kv_dtype: str = "fp32", route_policy: str = "static",
                   dispatch_ahead: int = 1, device="cuda") -> dict:
    """Open-loop scenario over the STAGED API: one request arrives every
    ``every`` decode steps whether or not the engine keeps up, driven by
    ``serving.frontend.run_open_loop`` with dispatch-ahead decode.
    Reports sustained tokens/s plus TTFT/TPOT percentiles (and per-shard
    tokens/s and requests when ``shards > 0``)."""
    from repro_torch.serving import frontend as FE
    dev = resolve_device(device)
    cfg, params = _model(arch, smoke, seed, dev)
    rng = np.random.default_rng(seed)
    max_len = _round_up(prompt_range[1] + gen_range[1], 16)
    eng = _make_engine(cfg, params, EngineConfig(
        max_seqs=max_seqs, max_seq_len=max_len, num_pages=num_pages,
        attn_backend=attn_backend, prefill_chunk=prefill_chunk,
        prefix_cache=prefix_cache, kv_dtype=kv_dtype,
        route_policy=route_policy, dispatch_ahead=dispatch_ahead,
        swap_bytes=swap_bytes), shards, device=dev)
    trace = [FE.TraceItem(
        prompt=rng.integers(0, cfg.vocab_size,
                            int(rng.integers(*prompt_range)),
                            dtype=np.int32),
        max_new_tokens=int(rng.integers(*gen_range)),
        arrival_step=i * every) for i in range(n_requests)]
    metrics = FE.time_open_loop(eng, trace)
    metrics.pop("_requests")
    print(f"open-loop: {metrics['requests']} requests, "
          f"{metrics['generated_tokens']} tokens in "
          f"{metrics['wall_s']:.2f}s "
          f"({metrics['sustained_tokens_per_s']:.1f} tok/s sustained); "
          f"ttft p50/p99 {metrics['ttft_p50_ms']:.0f}/"
          f"{metrics['ttft_p99_ms']:.0f} ms; "
          f"tpot p50/p99 {metrics['tpot_p50_ms']:.1f}/"
          f"{metrics['tpot_p99_ms']:.1f} ms; "
          f"pipeline depth peak {metrics['dispatch_depth_peak']} "
          f"(dispatch_ahead={dispatch_ahead}); "
          f"{metrics['preemptions']} preemptions")
    if shards:
        _shard_report(eng, metrics)
    return metrics


def serve_http(arch: str, port: int, host: str = "127.0.0.1",
               max_seqs: int = 8, num_pages: int = 0, smoke: bool = True,
               attn_backend: str = "reference", seed: int = 0,
               prefill_chunk: int = 0, shards: int = 0,
               prefix_cache: bool = False,
               swap_bytes: int = EngineConfig.swap_bytes,
               kv_dtype: str = "fp32", route_policy: str = "static",
               dispatch_ahead: int = 1, max_seq_len: int = 512,
               device="cuda") -> None:
    """Minimal stdlib-asyncio HTTP front end over :class:`AsyncFrontend`.

      POST /generate  {"prompt": [ids...], "max_new_tokens": N}
        → JSON lines, one {"token": t} per generated token, then a
          final {"done": true, "tokens": [...], "ttft_ms": ...} record
          (Connection: close framing — curl streams it as it decodes).
      GET /stats → engine stats snapshot.

    Serves until interrupted (SIGINT ends it cleanly).  One engine, many
    concurrent connections: the frontend's pump task interleaves their
    requests through the staged API with dispatch-ahead decode."""
    import asyncio
    import json

    from repro_torch.serving import frontend as FE
    dev = resolve_device(device)
    cfg, params = _model(arch, smoke, seed, dev)
    eng = _make_engine(cfg, params, EngineConfig(
        max_seqs=max_seqs, max_seq_len=_round_up(max_seq_len, 16),
        num_pages=num_pages, attn_backend=attn_backend,
        prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
        kv_dtype=kv_dtype, route_policy=route_policy,
        dispatch_ahead=dispatch_ahead, swap_bytes=swap_bytes), shards,
        device=dev)
    fe = FE.AsyncFrontend(eng)

    def _resp(writer, status: str, body: bytes,
              ctype: str = "application/json") -> None:
        writer.write(
            f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)

    async def handle(reader, writer):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
            line, _, rest = head.partition(b"\r\n")
            method, path, _ = line.decode().split(" ", 2)
            clen = 0
            for h in rest.decode().split("\r\n"):
                if h.lower().startswith("content-length:"):
                    clen = int(h.split(":", 1)[1])
            body = await reader.readexactly(clen) if clen else b""
            if method == "GET" and path == "/stats":
                _resp(writer, "200 OK",
                      json.dumps(eng.stats).encode() + b"\n")
            elif method == "POST" and path == "/generate":
                spec = json.loads(body)
                req = fe.submit(
                    np.asarray(spec["prompt"], np.int32),
                    max_new_tokens=int(spec.get("max_new_tokens", 32)),
                    eos_id=spec.get("eos_id"))
                writer.write(b"HTTP/1.1 200 OK\r\n"
                             b"Content-Type: application/json\r\n"
                             b"Connection: close\r\n\r\n")
                async for tok in fe.stream(req):
                    writer.write(json.dumps({"token": tok}).encode()
                                 + b"\n")
                    await writer.drain()
                writer.write(json.dumps(
                    {"done": True, "tokens": list(req.out),
                     "ttft_ms": (req.t_first - req.arrival) * 1e3,
                     "preempted": req.n_preempt > 0}).encode() + b"\n")
            else:
                _resp(writer, "404 Not Found", b'{"error": "not found"}\n')
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def main_async():
        await fe.start()
        server = await asyncio.start_server(handle, host, port)
        addr = server.sockets[0].getsockname()
        print(f"serving {arch} on http://{addr[0]}:{addr[1]} "
              f"(POST /generate, GET /stats) on {dev}", flush=True)
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(main_async())
    except KeyboardInterrupt:
        pass


def serve_fixed(arch: str, batch: int = 4, prompt_len: int = 64,
                gen: int = 32, smoke: bool = True,
                attn_backend: str = "reference", seed: int = 0,
                device="cuda") -> np.ndarray:
    """Legacy synchronous loop: one dense-cache prefill + lockstep greedy
    decode.  The paged engine's token oracle, and the fallback for
    configs the engine does not cover.  Returns int32 tokens of shape
    (batch, gen).

    After the prompts, the same ``default_rng(seed)`` draws the stub
    frontends' inputs, as the reference's does: N(0, 1) image embeddings
    ``cross_kv`` (batch, num_image_tokens, d_model) for the ``vlm``
    family, frame embeddings ``src_embeds`` (batch, num_audio_frames,
    d_model) for ``encdec``, both in ``cfg.dtype`` and handed to every
    step (the encoder reruns in each)."""
    from repro_torch.core import backends as B
    dev = resolve_device(device)
    attn_backend = B.resolve_backend_spec(attn_backend, default="reference")
    cfg, params = _model(arch, smoke, seed, dev)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len)),
                              dtype=torch.int32, device=dev)
    extras = S.stub_frontend_inputs(cfg, rng, batch, dev)
    caches = T.init_caches(cfg, batch, prompt_len + gen,
                           dtype=getattr(torch, cfg.dtype), device=dev)
    prefill_fn = S.make_prefill_step(cfg, backend=attn_backend)
    decode_fn = S.make_decode_step(cfg, backend=attn_backend)

    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, prompts, caches, **extras)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tok.cpu()]                 # waits for the prefill
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(gen - 1):
        tok, caches = decode_fn(params, tok, caches, **extras)
        out.append(tok)
    toks = torch.cat([t.cpu() for t in out], dim=1).numpy()
    t_decode = time.perf_counter() - t0
    print(f"prefill: {batch}×{prompt_len} tokens in {t_prefill:.2f}s; "
          f"decode: {batch}×{gen} tokens in {t_decode:.2f}s "
          f"({batch * gen / max(t_decode, 1e-9):.1f} tok/s) on {dev}")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="moba-340m",
                    choices=sorted(configs.ARCHS))
    ap.add_argument("--mode", default="stream",
                    choices=["stream", "openloop", "batch", "fixed"],
                    help="stream: Poisson arrivals through the engine "
                         "(default); openloop: one arrival every --every "
                         "decode steps over the staged API; batch: one "
                         "synchronous engine run; fixed: the dense-cache "
                         "fixed-batch loop")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch/fixed modes only (default 4)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="batch/fixed modes only (default 64)")
    ap.add_argument("--gen", type=int, default=None,
                    help="batch/fixed modes only (default 32)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="stream mode: Poisson arrival rate, req/s")
    ap.add_argument("--every", type=int, default=4,
                    help="openloop mode: one request arrives every N "
                         "decode steps (deterministic open-loop load)")
    ap.add_argument("--dispatch-ahead", type=int, default=1,
                    help="decode steps the host enqueues before blocking "
                         "on the previous step's tokens (0 = fully "
                         "synchronous dispatch)")
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="serve an asyncio HTTP front end on this port "
                         "instead of running a canned scenario "
                         "(POST /generate streams JSON-lines tokens)")
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=512,
                    help="--http only: per-sequence prompt + generation "
                         "capacity of the server's engine")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page pool size (0 = fully provisioned); "
                         "undersize it to exercise preemption")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn-backend", default=None,
                    help="registered attention backend, optionally with "
                         "an option suffix (reference | xla | flash, "
                         "flash:grouped | flash:flat; default reference)")
    ap.add_argument("--moba-impl", default=None,
                    help=argparse.SUPPRESS)   # removed: structured error
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
    ap.add_argument("--shards", type=int, default=0,
                    help="page-pool shards (0 = single-device engine): "
                         "shard i on cuda:i, or all on the CPU with "
                         "--device cpu; per-shard sizing comes from "
                         "--max-seqs / --num-pages")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    backend = args.attn_backend or "reference"
    common = dict(smoke=args.smoke, attn_backend=backend, seed=args.seed,
                  device=args.device, shards=args.shards,
                  kv_dtype=args.kv_dtype, route_policy=args.route_policy,
                  prefill_chunk=args.prefill_chunk,
                  prefix_cache=args.prefix_cache,
                  swap_bytes=args.swap_bytes)
    pools = dict(max_seqs=args.max_seqs, num_pages=args.num_pages)
    try:
        if args.moba_impl is not None:
            raise ServingError(
                f"--moba-impl was removed; use --attn-backend "
                f"{args.moba_impl} (same values — no silent precedence "
                f"between the two flags)")
        if args.http:
            serve_http(args.arch, port=args.http,
                       dispatch_ahead=args.dispatch_ahead,
                       max_seq_len=args.max_seq_len, **pools, **common)
        elif args.mode == "openloop":
            serve_openloop(args.arch, n_requests=args.requests,
                           every=args.every,
                           dispatch_ahead=args.dispatch_ahead, **pools,
                           **common)
        elif args.mode == "stream":
            ignored = [n for n, v in (("--batch", args.batch),
                                      ("--prompt-len", args.prompt_len),
                                      ("--gen", args.gen)) if v is not None]
            if ignored:
                print(f"warning: {', '.join(ignored)} only apply to "
                      f"--mode batch/fixed; stream mode draws mixed "
                      f"lengths from its own ranges", file=sys.stderr)
            serve_stream(args.arch, n_requests=args.requests,
                         rate=args.rate, **pools, **common)
        else:
            serve(args.arch, batch=args.batch or 4,
                  prompt_len=args.prompt_len or 64, gen=args.gen or 32,
                  use_engine="never" if args.mode == "fixed" else "auto",
                  **common)
    except ServingError as e:  # unsupported config / impossible sizing
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
