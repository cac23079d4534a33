#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  1. env     — card name and power limit, torch/CUDA versions, the CUDA
               kernels built from ``src/repro_torch/kernels/csrc`` (build
               seconds, ptxas register report).
  2. kernel  — the paged MoBA decode kernel against its plain PyTorch
               version at moba-340m decode shapes (B=8, H=Hkv=16, d=64,
               page 128, top_k 8, a 320-page pool, shuffled block tables,
               ragged kv_len with 0, 1, an exact page boundary and a
               table shorter than top_k) in bf16 (atol/rtol 3e-2) and
               fp32 (1e-3, TF32 off), plus a G=2, d=128 geometry.  Times
               from CUDA events (median of 25, L2 flushed before each):
               the kernel's wrapper, the plain version, and
               ``scaled_dot_product_attention`` over the gathered pages
               as the library yardstick; the bytes bound from this run's
               inputs at 3.35 TB/s.
  3. serve   — moba-340m at full width (bf16, random weights from a
               seeded torch.Generator) through ``Engine`` on the ``flash``
               backend: 8 prompts of 1024..4095 tokens, 64 new tokens
               each.  Every request must finish with 64 tokens and the
               decode kernel must have launched exactly 12 times (one per
               MoBA layer) per decode step.
  4. logits  — the same model in fp32 (TF32 off): one shared paged
               prefill, then one decode step under ``flash`` and one under
               ``xla`` from cloned caches; logits within 2e-3 and equal
               greedy tokens.

Then the kernel line, and as the last line
``{"ok": true, "device": {...}}``.  Without a usable card, or run from a
directory that lacks the repository's ``src/repro_torch``, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/moba_decode.cu"
TPU_KERNEL = "src/repro/kernels/moba_decode.py:347"
MOBA_LAYERS = 12                   # moba-340m: 24 layers, swa/moba


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_events_ms(fn, reps: int = 25, flush=None) -> float:
    """Median device time of ``fn`` from CUDA events; ``flush`` (a large
    tensor) is overwritten before each run so L2 starts cold, as it does
    for one layer's decode inside a full model step."""
    import torch
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# ------------------------------------------------------------------ phase 1
def phase_env():
    import torch
    from repro_torch.kernels import runtime
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = runtime.build(["moba_decode"])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in reports["moba_decode"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "nvcc": runtime.nvcc_path(), "build_s": round(build_s, 3),
          "ptxas": ptxas})
    return smi


# ------------------------------------------------------------------ phase 2
def _paged_case(*, b, h, hkv, d, ps, npg, num_pages, kv_lens, dtype, seed):
    """A pool filled through the port's own prefill append (so centroids
    are the engine's), shuffled physical pages, ragged lengths."""
    import torch
    from repro_torch.serving import paged_cache as PC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = {"pages_k": torch.randn((num_pages, ps, hkv, d), generator=gen,
                                   device=dev).to(dtype),
            "pages_v": torch.randn((num_pages, ps, hkv, d), generator=gen,
                                   device=dev).to(dtype),
            "centroids": torch.zeros((num_pages, hkv, d), device=dev)}
    perm = torch.randperm(num_pages, generator=gen, device=dev).tolist()
    table = np.full((b, npg), -1, np.int32)
    for i, n in enumerate(kv_lens):
        for j in range(-(-n // ps)):
            table[i, j] = perm.pop()
    table = torch.as_tensor(table, device=dev)
    kv = torch.as_tensor(kv_lens, dtype=torch.int32, device=dev)
    k_new = torch.randn((b, hkv, npg * ps, d), generator=gen, device=dev)
    v_new = torch.randn((b, hkv, npg * ps, d), generator=gen, device=dev)
    PC.paged_append_prefill(pool, table, kv, k_new.to(dtype),
                            v_new.to(dtype))
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(dtype)
    return q, pool, table, kv


def _decode_bytes_and_flops(q, pool, table, kv, idx, sel_valid, tables):
    """Bytes the decode function must move for these inputs (each read
    once, the output written once: the K/V rows of the valid tokens of
    each row's union pages, the centroid rows of the assigned table
    entries, q, the output, the tables) and its operations."""
    phys, base, n_uniq = tables
    b, h, _, d = q.shape
    _, ps, hkv, _ = pool["pages_k"].shape
    npg = table.shape[1]
    esz = pool["pages_k"].element_size()
    kvl = kv.long().repeat_interleave(hkv)[:, None, None]    # (B*Hkv,1,1)
    uslot = (np.arange(phys.shape[1])[None, :]
             < n_uniq.cpu().numpy()[:, None])                # (B*Hkv,U)
    page_base = base.min(dim=1).values.long()                # (B*Hkv,U)
    valid_tok = (kvl[:, 0] - page_base).clamp(0, ps).cpu().numpy()
    kv_tokens = float((valid_tok * uslot).sum())
    head_tokens = float(((kvl - base.long()).clamp(0, ps)).sum())
    nbytes = (2 * kv_tokens * d * esz                        # K and V rows
              + int((table >= 0).sum()) * hkv * d * 4        # centroid rows
              + table.numel() * 4 + kv.numel() * 4
              + 2 * q.numel() * q.element_size())            # q in, o out
    flops = (2 * b * h * npg * d                             # routing
             + 4 * head_tokens * d)                          # QK and PV
    return nbytes, flops


def phase_kernel():
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.core.moba import moba_paged_decode_attention
    from repro_torch.kernels import moba_decode as MD

    cfg = MoBAConfig(block_size=128, top_k=8)
    kv_lens = [0, 1, 128, 100, 1500, 3000, 4224, 2777]
    main = dict(b=8, h=16, hkv=16, d=64, ps=128, npg=33, num_pages=320,
                kv_lens=kv_lens)
    g2 = dict(b=4, h=16, hkv=8, d=128, ps=128, npg=12, num_pages=64,
              kv_lens=[0, 700, 1536, 129])
    tols = {torch.bfloat16: 3e-2, torch.float32: 1e-3}
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    checks, timing = [], None
    for name, geom in (("moba-340m", main), ("g2-d128", g2)):
        for dtype in (torch.bfloat16, torch.float32):
            q, pool, table, kv = _paged_case(dtype=dtype, seed=7, **geom)
            args = (q, pool["pages_k"], pool["pages_v"], pool["centroids"],
                    table, kv, cfg)
            out = MD.moba_paged_decode(*args)
            ref = moba_paged_decode_attention(*args)
            torch.cuda.synchronize()
            act = kv > 0
            err = float((out[act].float() - ref[act].float()).abs().max())
            tol = tols[dtype]
            ok = bool(torch.allclose(out[act].float(), ref[act].float(),
                                     atol=tol, rtol=tol))
            zeros = bool((out[~act] == 0).all())
            checks.append({"geometry": name, "dtype": str(dtype),
                           "max_abs_err": err, "tol": tol, "ok": ok,
                           "inactive_rows_zero": zeros})
            if not (ok and zeros):
                emit({"phase": "kernel", "checks": checks})
                raise SystemExit(f"kernel disagrees with its plain version: "
                                 f"{checks[-1]}")
            if name == "moba-340m" and dtype == torch.bfloat16:
                timing = _time_decode(q, pool, table, kv, cfg, args, err,
                                      flush)
    emit({"phase": "kernel", "checks": checks, **timing})
    return timing


def _time_decode(q, pool, table, kv, cfg, args, err, flush):
    import torch
    from repro_torch.core.moba import moba_paged_decode_attention as plain
    from repro_torch.core.moba import moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    idx, sel_valid = moba_paged_route(q, pool["centroids"], table, kv, cfg,
                                      page_size=pool["pages_k"].shape[1])
    tables = MD.decode_tables(q, pool["pages_k"], table, idx, sel_valid)
    scale = q.shape[-1] ** -0.5
    ms = cuda_events_ms(lambda: MD.moba_paged_decode(*args), flush=flush)
    kernel_only_ms = cuda_events_ms(
        lambda: MD.launch(q, pool["pages_k"], pool["pages_v"], kv, *tables,
                          scale), flush=flush)
    plain_ms = cuda_events_ms(lambda: plain(*args), flush=flush)
    # library yardstick: SDPA over the selected pages, gathered beforehand
    b, h, _, d = q.shape
    _, ps, hkv, _ = pool["pages_k"].shape
    phys = table.clamp(min=0).long()[
        torch.arange(b, device=q.device)[:, None, None, None, None], idx]
    heads = torch.arange(hkv, device=q.device)[None, :, None, None, None]
    kg = pool["pages_k"].permute(2, 0, 1, 3)[heads, phys]  # (B,Hkv,G,1,k,ps,d)
    vg = pool["pages_v"].permute(2, 0, 1, 3)[heads, phys]
    kg = kg.reshape(b, h, -1, d)
    vg = vg.reshape(b, h, -1, d)
    pos = idx[..., None] * ps + torch.arange(ps, device=q.device)
    mask = ((pos < kv[:, None, None, None, None, None])
            & sel_valid[..., None]).reshape(b, h, 1, -1)
    library_ms = cuda_events_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask), flush=flush)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q, kg, vg, attn_mask=mask)
    act = kv > 0
    ref = plain(*args)
    sdpa_err = float((sdpa[act].float() - ref[act].float()).abs().max())
    nbytes, flops = _decode_bytes_and_flops(q, pool, table, kv, idx,
                                            sel_valid, tables)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    return {"ms": ms, "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": sdpa_err,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err}


# ------------------------------------------------------------------ phase 3
def phase_serve():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = get_config("moba-340m")
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=8, max_prefill_batch=2, max_seq_len=4224,
        attn_backend="flash"), device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(1024, 4096, 8)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, int(n),
                                    dtype=np.int32), max_new_tokens=64)
            for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    MD.LAUNCHES = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = MD.LAUNCHES
    st = dict(eng.stats)           # the profile window below adds steps
    outs_ok = all(len(r.out) == 64 and r.done for r in reqs)
    toks = np.concatenate([np.asarray(r.out) for r in reqs])
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    rec = {"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
           "prompt_lens": [int(n) for n in lens], "new_tokens": 64,
           "requests_done": sum(r.done for r in reqs),
           "prefill_tokens": st["prefill_tokens"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tokens": st["decode_tokens"],
           "decode_steps": st["decode_steps"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
           "wall_s": wall, "preemptions": st["preemptions"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kernel_launches": launches,
           "launches_per_step": launches / max(st["decode_steps"], 1)}
    rec["profile"] = _profile_decode(eng, cfg, rng)
    emit(rec)
    if not outs_ok or not in_vocab:
        raise SystemExit("serve: a request did not finish with 64 tokens "
                         "in the vocabulary")
    if launches != MOBA_LAYERS * st["decode_steps"]:
        raise SystemExit(f"serve: {launches} kernel launches for "
                         f"{st['decode_steps']} decode steps, expected "
                         f"{MOBA_LAYERS} per step")
    return launches


def _profile_decode(eng, cfg, rng, steps: int = 6):
    """Where a decode step's time goes, after the measured run: 8 fresh
    1024-token requests staged in, then ``steps`` generate_step calls
    under torch.profiler.  Device busy share = summed kernel time over
    the window's wall time (one stream, so kernels do not overlap); the
    profiler's own host cost lengthens the wall time a little."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.make_request(rng.integers(0, cfg.vocab_size, 1024,
                                          dtype=np.int32), steps + 4)
            for _ in range(8)]
    for r in reqs:
        if not eng.insert(eng.prefill(r)):
            raise SystemExit("profile: a staged request went stale")
    eng.generate_step()                       # fill the pipeline
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.generate_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()                                 # finish the window's requests
    avgs = prof.key_averages()
    # kernel rows only: an operator's row repeats its kernels' time
    dev = sorted(((a.key, a.self_device_time_total, a.count) for a in avgs
                  if a.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda r: -r[1])
    device_us = sum(t for _, t, _ in dev)
    host = sorted(((a.key, a.self_cpu_time_total, a.count) for a in avgs),
                  key=lambda r: -r[1])
    launch_calls = sum(c for k, _, c in host if k.startswith("cudaLaunch"))
    return {"steps": steps, "batch": len(reqs),
            "step_ms": wall / steps * 1e3,
            "device_busy_ms_per_step": device_us / steps / 1e3,
            "device_idle_share": 1.0 - device_us / (wall * 1e6),
            "kernels_per_step": sum(c for _, _, c in dev) / steps,
            "launch_calls_per_step": launch_calls / steps,
            "top_device": [{"op": k, "us_per_step": t / steps,
                            "calls_per_step": c / steps}
                           for k, t, c in dev[:8]],
            "top_host": [{"op": k, "us_per_step": t / steps,
                          "calls_per_step": c / steps}
                         for k, t, c in host[:8]]}


# ------------------------------------------------------------------ phase 4
def phase_logits():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("moba-340m"), dtype="float32")
    params = T.init_lm(torch.Generator(device=dev).manual_seed(1), cfg)
    ps, npg = 128, 33
    lens = np.array([1500, 900, 2000, 300], np.int32)
    b = len(lens)
    rng = np.random.default_rng(1)
    pages = rng.permutation(b * npg)
    table = np.full((b, npg), -1, np.int32)
    for i, n in enumerate(lens):
        m = -(-(int(n) + 1) // ps)
        table[i, :m] = pages[i * npg:i * npg + m]
    tokens = np.zeros((b, 2048), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    caches = T.init_paged_caches(cfg, b * npg, ps, dtype=torch.float32,
                                 device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        tokens=tokens, table=table, kv0=np.zeros(b, np.int32), lens=lens,
        slots=np.arange(b, dtype=np.int32),
        active=np.ones(b, bool)).items()}
    first, caches = S.make_paged_prefill_step(cfg, "xla", chunked=True)(
        params, t["tokens"], caches, t["table"], t["kv0"], t["lens"],
        t["slots"], t["active"])
    page_state = {"block_table": t["table"], "kv_len": t["lens"],
                  "q_len": t["active"].to(torch.int32),
                  "active": t["active"]}
    logits, toks = {}, {}
    for backend in ("flash", "xla"):
        cloned = {s: {k: v.clone() for k, v in pool.items()}
                  for s, pool in caches.items()}
        lg, _ = T.decode_step(params, first[:, None], cfg, cloned,
                              backend=backend, page_state=page_state)
        step_tok, _ = S.make_paged_decode_step(cfg, backend)(
            params, first, {s: {k: v.clone() for k, v in pool.items()}
                            for s, pool in caches.items()},
            t["table"], t["lens"], t["active"])
        logits[backend] = lg[:, -1]
        toks[backend] = step_tok
    torch.cuda.synchronize()
    diff = float((logits["flash"] - logits["xla"]).abs().max())
    ok = bool(torch.allclose(logits["flash"], logits["xla"], atol=2e-3,
                             rtol=2e-3))
    finite = bool(torch.isfinite(logits["flash"]).all())
    same = bool(torch.equal(toks["flash"], toks["xla"])
                and torch.equal(toks["flash"],
                                logits["flash"].argmax(-1).to(torch.int32)))
    emit({"phase": "logits", "dtype": "float32", "batch": b,
          "kv_lens": lens.tolist(), "vocab": cfg.vocab_size,
          "max_abs_diff": diff, "tol": 2e-3, "allclose": ok,
          "finite": finite, "greedy_equal": same})
    if not (ok and finite and same):
        raise SystemExit("logits: flash and xla decode steps disagree")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the "
              f"repository root", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env()
    timing = phase_kernel()
    launches = phase_serve()
    phase_logits()
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "moba_paged_decode", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"], "checked": True}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
