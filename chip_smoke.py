#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  1. env     — card name and power limit, torch/CUDA versions, the six
               CUDA kernels built from ``src/repro_torch/kernels/csrc``
               (build seconds, ptxas register report).
  2. kernel  — the paged MoBA decode kernels (route, split-page
               attention, merge) against their plain PyTorch versions at
               moba-340m decode shapes (B=8, H=Hkv=16, d=64, page 128,
               top_k 8, a 320-page pool, shuffled block tables, ragged
               kv_len with 0, 1, an exact page boundary and a table
               shorter than top_k), a G=2, d=128 geometry, and page 16
               with top_k 64 and with top_k 128 over 512-page tables (G=2:
               the route's running top-k across four 128-page chunks; at
               top_k 128 its lists hold 256 slots a row in dynamic shared
               memory), and G=8 at d 128 with top_k 200 over 512-page
               tables (the route's static and dynamic shared memory
               together past 48 KB, each record giving both); q in bf16
               and fp32 (TF32 off), pools in q's dtype and int8 and fp8
               (the dequant path) filled from the same keys and values.
               Each check reads the route tables of the decode call it
               checks (``launch`` returns them), and the public wrapper's
               output must equal that call's bit for bit.  The route's
               selections against ``moba_paged_route``: equal except on
               near-ties (sorted selected scores within 1e-5·max(1, |s|)
               on ``paged_route_scores``), the count printed; its union
               tables equal ``decode_tables`` on its own selections.  The
               attention against the plain attention
               (``moba_paged_attend``) on those selections (bf16 3e-2,
               fp32 1e-3), inactive rows zero; quantized pools also
               against the unquantized plain attention on the same q and
               K/V (int8 5e-2, fp8 2e-1).  Times per pool dtype at the
               main shapes with bf16 q (``call_cost``: device ms from
               CUDA events, median of 25, a spin kernel then a 256 MB
               write before each, so the host is hidden and L2 is cold;
               µs a call in loops of 20; their larger as ``ms``): the
               decode call, the plain version and
               ``scaled_dot_product_attention`` over the gathered (and
               dequantized) pages as the library call; device ms of the
               three launches alone, also after a read flush (clean L2);
               the bytes bound from this run's inputs at 3.35 TB/s; and,
               with torch.profiler over one call, the port's kernel
               launches (exactly 3, device µs each) and any other
               operator that ran device work (none allowed); a trace
               with no device event at all is retaken, up to 3 times.
               Then the route kernel with per-head budgets (adaptive
               routing's ``head_top_k``, 1..top_k dealt unequally over a
               GQA group) from bf16 and int8 pools at moba-340m's shape
               (G 1, d 64), G 2 at d 128, G 8 at d 128 with top_k 200
               and G 8 over 100-page tables (npg < top_k) with a kv_len 0
               row: selections against ``moba_paged_route`` with the same
               budgets (near-ties only), tables equal to
               ``route_tables_plain``'s (or ``decode_tables``' on the
               kernel's own selections where a near-tie flipped one), no
               head past its budget, the attention against the plain
               attention on those selections (3e-2), and a union smaller
               than the static call's; and at the main shape the call with
               and without budgets (``call_cost``, the launches alone,
               the bytes bound from the union each read, mean
               ``n_uniq``).
  3. serve   — moba-340m at full width (bf16, random weights from a
               seeded torch.Generator) through ``Engine`` on the ``flash``
               backend: 8 prompts of 1024..4095 tokens, 64 new tokens
               each.  Every request must finish with 64 tokens, the decode
               call must have run exactly 12 times (one per MoBA layer) per
               decode step and launched exactly 3 kernels each time.  Then
               the same cell from int8 and from fp8 pools
               (``serve_quantized``, 32 new tokens):
               the same checks, decode tokens/s and step ms, and the
               pools' bytes against the bf16 run's.  Then
               ``serve_key_conv``: moba-340m-kconv3 (key convolution of
               width 3 on the MoBA layers) with the same prompts, 32 new
               tokens, ``prefill_chunk`` 1000 (chunk edges inside conv
               windows and off page edges), from bf16 and from int8
               pools: the same checks, and the per-slot ring
               ``key_conv_state`` bf16 of shape (12, 8, 16, 2, 64) in
               both.
  4. logits  — the same model in fp32 (TF32 off): one shared paged
               prefill, then one decode step under ``flash`` and one under
               ``xla`` from cloned caches; logits within 2e-3 and equal
               greedy tokens.  The flash run records the selections each
               decode call's route kernel made, in every MoBA layer; the
               xla run replays them, and each may differ from xla's own
               routing only on a near-tie (counted).  Repeated from int8
               and from fp8 pools.  Then ``key_conv_logits``: the kconv3
               model in fp32 after a prefill in chunks of 1000; every
               sequence's ring row must equal the last 2 of the raw keys
               its chunks computed (recomputed one-shot) bit for bit,
               pages and centroids a one-shot prefill's within 2e-4, and
               the decode step passes phase 4's check; then a swap
               check at 4 layers (full width, fp32): four prompts just
               under a page boundary in a pool one page larger than
               they take, so growth preempts by swap (at least one
               restore); every restored ring row equals its snapshot
               bit for bit, and each greedy stream equals an engine's
               with room for all up to its first step whose top-2
               logit gap (teacher-forced, ``reference``) is at most
               1e-3 (counted).  Then ``serve_qwen3``: qwen3-0.6b at
               full width and depth (28 MoBA layers, d 128, 16 heads on
               8 kv heads, tied 151,936-token embeddings, qk-norm),
               bf16, 4 of the prompts, 16 new tokens: every request
               finishes, 28 decode calls and 84 kernel launches a step,
               decode tokens/s, step ms, peak memory and a profiled
               window; then phase 4's check on this model in fp32.  Then
               ``serve_adaptive``: moba-340m (bf16) on ``flash`` with
               phase 3's prompts and 32 new tokens under static routing,
               (a) ``route_policy="snr:pfail=0.01"`` (calibrated at engine
               build: the profile's summary and the calibration's
               seconds) and (b) a non-uniform profile (every other head at
               budget 1, the rest cycling through 2..top_k) saved to a
               temporary file and loaded with ``profile:PATH``; (b) again
               on ``xla`` and from an int8 pool; then phase 4's fp32 check
               under (b).  Under (b): every request finishes, 12 decode
               calls and 36 kernels a step, the stream differs from
               static's, flash and xla streams part only where either
               run's top-2 bf16 logit gap is at most 0.0625, and a
               profiled step's launch calls equal static's; static and
               (b) each print the profiled step ms, device busy ms, idle
               share and mean ``n_uniq`` a (sequence, kv head).
  5. train_kernels — the four FlashMoBA training kernels (centroids, Flash
               TopK, forward, backward) against their plain PyTorch
               versions at the moba-340m training shapes (B=1, H=Hkv=16,
               N=Nq=8192, d=64, block 128, top_k 8, q tile 128) in bf16
               and fp32, plus G=2/d=128, a ragged N=8000, a query suffix
               Nq=1000, the paper's small blocks (``small-blocks``: block
               32, top_k 32, bf16 and fp32) and original MoBA's blocks
               (``block-512``: block 512, top_k 2, bf16: the forward's
               K/V ring and four backward key splits; ``block-512-d128``:
               the same at G=2, d 128, N 4096), Flash TopK's register
               bucket 16 (``top_k-16``: block 64, bf16) and its
               shared-memory lists (``top_k-64``: block 16, N 4096, bf16
               and fp32), and Flash TopK alone at its limit
               (``top_k-1024``: one head, N 32768, block 16, bf16).  The
               forward and backward run on a layout
               built from the plain routing; Flash TopK may differ from
               the plain routing only on near-ties (sorted selected scores
               within 1e-5·max(1, |s|)).  Tolerances: centroids bf16 1e-2,
               fp32 1e-5; forward (o, m, l) bf16 3e-2, fp32 2e-4; backward
               max |Δ| over the leaf's max |g|, bf16 3e-2, fp32 5e-3.
               The backward takes dO in q's dtype and must give
               bit-equal dQ/dK/dV on a second call with the same inputs.
               ``flash_moba`` forward and grads against the ``xla`` path
               (fp32 2e-4 / 5e-3; rows whose routing flipped on a near-tie
               are left out and counted).  First, a tensor-core audit of
               the Flash TopK, forward and backward libraries: per kernel
               function the registers and stack bytes (``cuobjdump
               -res-usage``) and the count of ``HMMA``/``HGMMA``
               instructions in its SASS; a bf16 instantiation with none,
               or a FlashMoBA one with a stack frame (a spill) at d 64,
               fails.  Per kernel at the main
               bf16 shapes: ``call_cost`` (as in phase 2) of the wrapper,
               the plain version and the library call where one computes
               the same thing (centroids: a mean), and the device ms of
               the launch alone; bytes, FLOPs and the bound from this
               run's tensors; centroids also after a read flush (clean
               L2) and, with the mean, under each placement of the spin
               kernel (``by_hold``); causal SDPA at the same shape as a
               yardstick (not the same function) for the forward and
               backward; the backward launch with runs cut into segments
               of 4, 8 and 16 tiles.  Flash TopK is timed at the main and
               the small-block shapes (``call_cost``, alone, plain, the
               bytes/FLOPs bound) beside a yardstick that is not the same
               function (its tie order differs): ``torch.topk`` over the
               masked ``torch.bmm`` scores; its launch alone and bound
               also at ``top_k-16``, ``top_k-64`` and ``top_k-1024``.
  6. train   — moba-340m at full width and depth (bf16, random weights
               from a seeded torch.Generator), batch 1, seq 8192, 4
               ``make_train_step`` steps on ``flash`` with remat; losses
               finite, each training kernel launched exactly as often as
               the path implies (per step: centroids, topk and forward 24
               — 12 MoBA layers, forward plus recompute — backward 12).
               Step time, tokens/s, peak memory, then one step under
               torch.profiler.  Then the same 4 steps on ``xla`` from the
               same weights and batches: each step's loss within 2e-2 of
               flash's (the kernels round P, dS and dO to bf16; xla
               multiplies in fp32).  Then ``train_small_blocks``: the
               same model at block 32, top_k 32, 3 steps on ``flash``
               (counts zeroed just before, read just after): finite
               losses, exact launch counts, step ms, peak memory.  Then
               ``train_key_conv``: moba-340m-kconv3, 3 steps on
               ``flash`` as phase 6's (counts zeroed just before, read
               just after): finite losses, phase 6's launch counts,
               every MoBA layer's ``key_conv`` gradient finite and
               nonzero in every step, the conv weights moved; step ms,
               tokens/s and peak memory beside phase 6's; then the same
               steps on ``xla``, each loss within 2e-2 of flash's.
  7. train_grads — the same weights in fp32 (TF32 off), batch 1, seq
               2048: ``lm_loss`` and every gradient leaf under ``flash``
               against ``xla`` (loss 2e-4 relative, each leaf max |Δ| /
               max |g| <= 5e-3), the xla run replaying the flash run's
               block selections; each layer's selections must differ
               from the plain routing only on near-ties.  Run at block
               128, top_k 8, again at block 32, top_k 32, and on the
               kconv3 model (the ``key_conv`` leaves among the checked).
  8. swa     — a tensor-core audit of the ``swa`` library first (as in
               phase 5: every bf16 instantiation has ``HMMA`` in its SASS,
               none has a stack frame at d 64; d 128's registers and
               stack reported).  ``swa_attention``'s CUDA kernel against
               its plain version in bf16 (the tensor-core body, 3e-2) and
               fp32 (the SIMT body, 2e-4) at moba-340m's SWA shapes (N
               8192, window 256, 16 heads, d 64) and the same at d 128,
               GQA geometries (H 16 on Hkv 8 and, ``gqa-g8``, 2 x 32
               heads on 4, both d 128), window 100 with q_tile 128 /
               k_tile 64, a window >= N, window 1 and N 96 (a ragged
               tile).  At the moba-340m shapes, d 64 and d 128, bf16 and
               fp32: the launch alone, ``call_cost`` of the wrapper, the
               plain version and causal SDPA with a band mask as the
               library call, the bound from these tensors (bf16 tensor-core or
               fp32 peak); in bf16 also ``flex_attention`` with a
               sliding-window ``BlockMask``, compiled once, as a second
               yardstick (its error instead if it cannot be built).  No
               serving or training path launches the kernel.

Then each phase's wall seconds and the script's total, the card's name
and power limit, the kernel line (the six kernels,
the decode kernels once per pool dtype; Flash TopK also with its
small-block times and its times alone at top_k 16, 64 and 1024;
``swa_attention`` also at d 128 and in fp32; ``launches_also``: each
kernel's launches on the other paths, ``serve_key_conv``,
``serve_qwen3`` and ``serve_adaptive`` (its (b) run) for the decode
kernels, whose bf16 entry also holds ``with_budgets``, ``train_small_blocks`` and
``train_key_conv`` for the training kernels), and as the last line
``{"ok": true, "device": {...}}``.

  python3 chip_smoke.py --ab DIR

runs none of the phases.  It times the checkout at DIR (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) and this one, each tree in a process of its own,
in the order DIR, this, this, DIR: the decode call on the phase-2 case
at moba-340m's shapes (bf16 q and pool, built by that tree's own
prefill append; ``call_cost`` of the call and of the library call, and
the CUDA-event reading without the spin kernel); the Flash TopK launch
(through its wrapper, whose only device work it is), ``moba_fwd.launch``
and ``moba_bwd.launch`` alone on the phase-5 moba-340m bf16 case (dO in
the dtype that tree's backward wrapper takes, read from its
``check_contract``); ``swa_attention`` through its public wrapper at
moba-340m's SWA shape (bf16 and fp32 at d 64, bf16 at d 128); and the
phase-6 median training step (steps 2–4).
The last line holds each tree's medians and the ratio DIR / this.

Without a usable card, or run from a directory that lacks the
repository's ``src/repro_torch``, it exits non-zero before printing any
result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
BF16_FLOPS = 989e12                # H100 SXM, dense bf16 tensor cores
CSRC = "src/repro_torch/kernels/csrc"
KERNEL_SOURCE = f"{CSRC}/moba_decode.cu"
TPU_KERNEL = "src/repro/kernels/moba_decode.py:347"
# training kernels: line name -> (port module, source, TPU kernel replaced)
TRAIN_KERNELS = {
    "block_centroids": ("centroids", f"{CSRC}/centroids.cu",
                        "src/repro/kernels/centroids.py:33"),
    "flash_topk": ("flash_topk", f"{CSRC}/flash_topk.cu",
                   "src/repro/kernels/flash_topk.py:247"),
    "moba_fwd": ("moba_fwd", f"{CSRC}/moba_fwd.cu",
                 "src/repro/kernels/moba_fwd.py:139"),
    "moba_bwd": ("moba_bwd", f"{CSRC}/moba_bwd.cu",
                 "src/repro/kernels/moba_bwd.py:167"),
}
SWA_KERNEL = ("swa_attention", f"{CSRC}/swa.cu", "src/repro/kernels/swa.py:77")
MOBA_LAYERS = 12                   # moba-340m: 24 layers, swa/moba
TRAIN_SEQ = 8192                   # the paper's training context
TRAIN_STEPS = 4
# flash vs xla loss of each training step in bf16: the kernels round P,
# dS and dO to bf16 where the xla path multiplies in fp32 (it rounds only
# P before P V), and AdamW carries the difference into the later steps
TRAIN_LOSS_TOL = 2e-2
KV_DTYPES = ("fp32", "int8", "fp8")
# quantized decode vs the unquantized plain version on the same K/V
# (tests/test_quantized_pages.py:41)
QUANT_TOL = {"int8": 5e-2, "fp8": 2e-1}
QUANT_NEW_TOKENS = 32
HOLD_CYCLES = 1_000_000            # ~0.5 ms of card time before a timed run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_events_ms(fn, reps: int = 25, flush=None, clean: bool = False,
                   hold: str = "first") -> float:
    """Median device time of ``fn`` from CUDA events; ``flush`` (a large
    tensor) is overwritten before each run so L2 starts cold, as it does
    for one layer's decode inside a full model step.  The overwrite
    leaves L2 full of dirty lines that ``fn``'s reads must write back;
    ``clean`` reads the tensor instead, so L2 holds clean lines.
    ``hold`` places a spin kernel (``HOLD_CYCLES``): "first" runs it
    before the flush, so the host has enqueued the flush and ``fn`` by
    the time the flush ends and the span is ``fn``'s device time;
    "after_flush" runs it between the flush and ``fn``; "none" runs no
    spin, so the span also holds whatever part of ``fn``'s host time
    outlasts the flush."""
    import torch
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        if hold == "first":
            torch.cuda._sleep(HOLD_CYCLES)
        if flush is not None and clean:
            flush.sum()
        elif flush is not None:
            flush.zero_()
        if hold == "after_flush":
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def loop_us(fn, calls: int = 20, reps: int = 5) -> float:
    """µs a call in a loop: the median over ``reps`` loops of ``calls``
    back-to-back calls and one synchronize.  That is the host's time per
    call where the host is slower than the card, else the card's (with a
    warm L2)."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    return float(np.median(per_call))


def call_cost(fn, flush, prefix: str = "") -> dict:
    """A call's cost on one yardstick: its device time with L2 flushed
    (``device_ms``), its µs a call in a back-to-back loop
    (``loop_us``), and ``ms``, the larger of the two: a call can go no
    faster than either the card or the host that issues it."""
    dev = cuda_events_ms(fn, flush=flush)
    loop = loop_us(fn)
    return {f"{prefix}ms": max(dev, loop / 1e3), f"{prefix}device_ms": dev,
            f"{prefix}loop_us": loop}


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
    reports = runtime.build(runtime.KERNELS)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, rep in reports.items()}
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "nvcc": runtime.nvcc_path(), "build_s": round(build_s, 3),
          "ptxas": ptxas})
    return smi


# ------------------------------------------------------------------ phase 2
def _paged_case(*, b, h, hkv, d, ps, npg, num_pages, kv_lens, dtype, seed,
                kv_dtype="fp32"):
    """A pool filled through the port's own prefill append (so centroids
    and, for int8/fp8 pools, payloads and scales are the engine's),
    shuffled physical pages, ragged lengths.  Pages no sequence owns keep
    finite garbage (and stale scales 3.0), as in a recycled pool.  One
    seed gives the same keys, values and queries for every ``kv_dtype``."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.serving import paged_cache as PC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    junk = [torch.randn((num_pages, ps, hkv, d), generator=gen, device=dev)
            for _ in range(2)]
    if kv_dtype == "fp32":
        pool = {"pages_k": junk[0].to(dtype), "pages_v": junk[1].to(dtype)}
    else:
        pool = {"pages_k": Q.quantize(junk[0], 0.05, kv_dtype),
                "pages_v": Q.quantize(junk[1], 0.05, kv_dtype),
                "scales_k": torch.full((num_pages, hkv), 3.0, device=dev),
                "scales_v": torch.full((num_pages, hkv), 3.0, device=dev)}
    pool["centroids"] = torch.zeros((num_pages, hkv, d), device=dev)
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


def _scales(pool) -> dict:
    return {k: pool[k] for k in ("scales_k", "scales_v") if k in pool}


def _decode_bytes_and_flops(q, pool, table, kv, idx, sel_valid, tables):
    """Bytes the decode function must move for these inputs (each read
    once, the output written once: the K/V rows of the valid tokens of
    each row's union pages and, for a quantized pool, their two scales,
    the centroid rows of the assigned table entries, q, the output, the
    tables) and its operations."""
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
              + (2 * 4 * float(uslot.sum()) if "scales_k" in pool else 0)
              + int((table >= 0).sum()) * hkv * d * 4        # centroid rows
              + table.numel() * 4 + kv.numel() * 4
              + 2 * q.numel() * q.element_size())            # q in, o out
    flops = (2 * b * h * npg * d                             # routing
             + 4 * head_tokens * d)                          # QK and PV
    return nbytes, flops


def _route_near_ties(q, centroids, table, kv, ps, sel, idx, sel_valid):
    """The route kernel's selections ``sel`` (B·Hkv, G, k; -1 invalid)
    against the plain route ``idx``/``sel_valid`` on the plain route's own
    masked scores: (rows differing, the largest gap, all differences
    near-ties)."""
    import torch
    from repro_torch.core import moba as CM
    npg, k = table.shape[1], sel.shape[-1]
    masked = CM.paged_route_scores(q, centroids, table, kv,
                                   ps).reshape(-1, npg)
    masked = torch.cat([masked, torch.full_like(masked[:, :1],
                                                CM.NEG_INF)], -1)
    got = torch.where(sel >= 0, sel.long(), npg).reshape(-1, k)
    want = torch.where(sel_valid, idx, npg).reshape(-1, k)
    return _near_ties(masked, got, want)


def _kernel_selection(rt, q, centroids):
    """The route kernel's selections as ``moba_paged_route`` returns its
    own: (idx, sel_valid), (B, Hkv, G, 1, k), invalid slots 0."""
    b, h = q.shape[:2]
    hkv = centroids.shape[1]
    sel = rt.sel.long().view(b, hkv, h // hkv, 1, -1)
    return sel.clamp(min=0), sel >= 0


def _decode_launch(q, pool, table, kv, cfg, head_top_k=None):
    """One decode call through the wrapper's own checks and launch:
    the output and the route tables that call attended with."""
    from repro_torch.kernels import moba_decode as MD
    sc = _scales(pool)
    MD.check_contract(q, pool["pages_k"], pool["pages_v"], **sc,
                      centroids=pool["centroids"], block_table=table,
                      kv_len=kv, top_k=cfg.top_k, head_top_k=head_top_k)
    return MD.launch(q, pool["pages_k"], pool["pages_v"], pool["centroids"],
                     table, kv, cfg.top_k, q.shape[-1] ** -0.5,
                     sc.get("scales_k"), sc.get("scales_v"), head_top_k)


def budget_table(hkv: int, g: int, top_k: int):
    """Per-head budgets for the kernel checks: 1 to top_k spread evenly
    over the H = hkv·G heads, dealt so that the heads of a GQA group get
    unequal budgets; (Hkv, G) int32 on the card."""
    import torch
    vals = np.linspace(1, top_k, hkv * g).round().astype(np.int32)
    return torch.as_tensor(vals.reshape(g, hkv).T.copy(), device="cuda")


def _mean_n_uniq(n_uniq, kv_len) -> float:
    """Mean union size over the (sequence, kv head) rows of sequences
    with ``kv_len`` > 0 (a kv_len 0 row still routes to its page 0)."""
    live = n_uniq[kv_len.repeat_interleave(n_uniq.numel() // kv_len.numel())
                  > 0]
    return float(live.float().mean()) if live.numel() else 0.0


def _check_budgets(name, geom, cfg, kv_dtype):
    """The route kernel with per-head budgets (bf16 q, a bf16 or int8
    pool): its selections against the plain route truncated to the same
    budgets (``moba_paged_route``; near-ties only), its tables equal to
    ``route_tables_plain``'s where the selections are equal (else to
    ``decode_tables`` on its own selections), no head past its budget,
    the attention against the plain attention on those selections, the
    public wrapper's output equal to the launch's, and no row's union
    larger than the static call's on the same inputs (``union_shrank``:
    smaller somewhere; a union that takes every page may not shrink)."""
    import torch
    from repro_torch.core.moba import moba_paged_attend, moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    q, pool, table, kv = _paged_case(dtype=torch.bfloat16, seed=7,
                                     kv_dtype=kv_dtype, **geom)
    sc = _scales(pool)
    cents, ps = pool["centroids"], pool["pages_k"].shape[1]
    htk = budget_table(geom["hkv"], geom["h"] // geom["hkv"], cfg.top_k)
    out, rt = _decode_launch(q, pool, table, kv, cfg, htk)
    _, rt0 = _decode_launch(q, pool, table, kv, cfg)
    call_equal = bool(torch.equal(out, MD.moba_paged_decode(
        q, pool["pages_k"], pool["pages_v"], cents, table, kv, cfg, **sc,
        head_top_k=htk)))
    plain = MD.route_tables_plain(q, cents, table, kv, cfg.top_k, ps,
                                  head_top_k=htk)
    idx, sel_valid = moba_paged_route(q, cents, table, kv, cfg,
                                      page_size=ps, head_top_k=htk)
    rows, gap, ties_ok = _route_near_ties(q, cents, table, kv, ps, rt.sel,
                                          idx, sel_valid)
    k_idx, k_valid = _kernel_selection(rt, q, cents)
    sel_equal = bool(torch.equal(rt.sel, plain.sel))
    want = ((plain.phys, plain.base, plain.n_uniq) if sel_equal else
            MD.decode_tables(q, pool["pages_k"], table, k_idx, k_valid))
    tables_equal = all(bool(torch.equal(a, b)) for a, b in
                       zip((rt.phys, rt.base, rt.n_uniq), want))
    b = q.shape[0]
    within = bool(((rt.sel >= 0).sum(-1)
                   <= htk.repeat(b, 1)).all())               # (B·Hkv, G)
    ref = moba_paged_attend(q, pool["pages_k"], pool["pages_v"], table, kv,
                            k_idx, k_valid, **sc)
    torch.cuda.synchronize()
    act = kv > 0
    err = float((out[act].float() - ref[act].float()).abs().max())
    close = bool(torch.allclose(out[act].float(), ref[act].float(),
                                atol=3e-2, rtol=3e-2))
    zeros = bool((out[~act] == 0).all())
    not_grown = bool((rt.n_uniq <= rt0.n_uniq).all())
    ok = (ties_ok and tables_equal and call_equal and within and close
          and zeros and not_grown)
    return {"geometry": name, "kv_dtype": kv_dtype, "dtype": "bf16",
            "top_k": cfg.top_k, "npg": geom["npg"],
            "budgets": sorted(set(htk.flatten().tolist())),
            "route_rows_differing": rows, "route_max_gap": gap,
            "route_near_ties_ok": ties_ok,
            "selections_equal_plain": sel_equal,
            "tables_equal": tables_equal, "within_budgets": within,
            "call_equals_launch": call_equal, "max_abs_err": err,
            "tol": 3e-2, "inactive_rows_zero": zeros,
            "mean_n_uniq": _mean_n_uniq(rt.n_uniq, kv),
            "mean_n_uniq_static": _mean_n_uniq(rt0.n_uniq, kv),
            "union_not_grown": not_grown,
            "union_shrank": int(rt.n_uniq.sum()) < int(rt0.n_uniq.sum()),
            "ok": ok}


def _time_budgets(geom, cfg, flush) -> dict:
    """The decode call with and without per-head budgets on the phase-2
    moba-340m case (bf16 q and pool), each as a call's cost, the
    launches alone, and the bytes bound from the union that call
    read."""
    import torch
    from repro_torch.kernels import moba_decode as MD
    q, pool, table, kv = _paged_case(dtype=torch.bfloat16, seed=7, **geom)
    htk = budget_table(geom["hkv"], geom["h"] // geom["hkv"], cfg.top_k)
    args = (q, pool["pages_k"], pool["pages_v"], pool["centroids"], table,
            kv)
    res = {}
    for label, h in (("static", None), ("budgets", htk)):
        _, rt = MD.launch(*args, cfg.top_k, q.shape[-1] ** -0.5,
                          head_top_k=h)
        nbytes, flops = _decode_bytes_and_flops(
            q, pool, table, kv, None, None, (rt.phys, rt.base, rt.n_uniq))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        res[label] = {
            **call_cost(lambda h=h: MD.moba_paged_decode(*args, cfg,
                                                         head_top_k=h),
                        flush),
            "kernel_only_ms": cuda_events_ms(
                lambda h=h: MD.launch(*args, cfg.top_k,
                                      q.shape[-1] ** -0.5, head_top_k=h),
                flush=flush),
            "mean_n_uniq": _mean_n_uniq(rt.n_uniq, kv),
            "union_pages": int(rt.n_uniq.sum()), "bytes": nbytes,
            "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    return res


def phase_kernel():
    """Unquantized pools first, then int8 and fp8 pools from the same
    keys and values.  The route kernel against the plain route (near-ties
    only); its tables against ``decode_tables`` on its own selections;
    the decode call against the plain attention on those selections, on
    its own pool and, quantized, against the unquantized pool of that q
    dtype.  Geometries: moba-340m's decode shapes; G=2 at d 128; and the
    small-block regime (page 16, top_k 64 = n/(8·bs) at an 8K context,
    ``benchmarks/fig3_efficiency.py``), whose 512-page tables take the
    route kernel's running top-k across four 128-page chunks, and the
    same tables at top_k 128 (G 2: 256 list slots a row, past the route's
    old 64-slot cap); G 8 at d 128 with top_k 200, where the route's
    static and dynamic shared memory together pass 48 KB."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.core.moba import moba_paged_attend, moba_paged_route
    from repro_torch.kernels import moba_decode as MD

    main_cfg = MoBAConfig(block_size=128, top_k=8)
    main = dict(b=8, h=16, hkv=16, d=64, ps=128, npg=33, num_pages=320,
                kv_lens=[0, 1, 128, 100, 1500, 3000, 4224, 2777])
    g2 = dict(b=4, h=16, hkv=8, d=128, ps=128, npg=12, num_pages=64,
              kv_lens=[0, 700, 1536, 129])
    k64 = dict(b=4, h=16, hkv=8, d=64, ps=16, npg=512, num_pages=1100,
               kv_lens=[8192, 6000, 2049, 0])
    # G 8 at d 128, top_k 200: the route's lists (44,800 bytes) fit the
    # 48 KB a block gets unasked, its static arrays on top do not
    g8 = dict(b=2, h=16, hkv=2, d=128, ps=16, npg=512, num_pages=900,
              kv_lens=[8192, 5001])
    geoms = (("moba-340m", main, main_cfg), ("g2-d128", g2, main_cfg),
             ("page16-k64", k64, MoBAConfig(block_size=16, top_k=64)),
             ("page16-k128", k64, MoBAConfig(block_size=16, top_k=128)),
             ("g8-k200-d128", g8, MoBAConfig(block_size=16, top_k=200)))
    tols = {torch.bfloat16: 3e-2, torch.float32: 1e-3}
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    checks, timing = [], {}
    for name, geom, cfg in geoms:
        unquantized = {}
        for kv_dtype in KV_DTYPES:
            for dtype in (torch.bfloat16, torch.float32):
                q, pool, table, kv = _paged_case(dtype=dtype, seed=7,
                                                 kv_dtype=kv_dtype, **geom)
                sc = _scales(pool)
                ps = pool["pages_k"].shape[1]
                args = (q, pool["pages_k"], pool["pages_v"],
                        pool["centroids"], table, kv, cfg)
                out, rt = _decode_launch(q, pool, table, kv, cfg)
                call_equal = bool(torch.equal(
                    out, MD.moba_paged_decode(*args, **sc)))
                idx, sel_valid = moba_paged_route(q, pool["centroids"],
                                                  table, kv, cfg,
                                                  page_size=ps)
                rows, gap, ties_ok = _route_near_ties(
                    q, pool["centroids"], table, kv, ps, rt.sel, idx,
                    sel_valid)
                k_idx, k_valid = _kernel_selection(rt, q, pool["centroids"])
                want = MD.decode_tables(q, pool["pages_k"], table, k_idx,
                                        k_valid)
                tables_equal = all(bool(torch.equal(a, b)) for a, b in
                                   zip((rt.phys, rt.base, rt.n_uniq), want))
                ref = moba_paged_attend(q, pool["pages_k"], pool["pages_v"],
                                        table, kv, k_idx, k_valid, **sc)
                torch.cuda.synchronize()
                act = kv > 0
                err = float((out[act].float() - ref[act].float()).abs().max())
                tol = tols[dtype]
                ok = bool(torch.allclose(out[act].float(), ref[act].float(),
                                         atol=tol, rtol=tol))
                zeros = bool((out[~act] == 0).all())
                rec = {"geometry": name, "kv_dtype": kv_dtype,
                       "dtype": str(dtype), "top_k": cfg.top_k,
                       "route_smem_bytes": MD.route_smem_bytes(
                           geom["h"] // geom["hkv"], cfg.top_k,
                           geom["npg"], geom["d"]),
                       "max_abs_err": err, "tol": tol,
                       "route_rows_differing": rows,
                       "route_rows": int(rt.sel.shape[0] * rt.sel.shape[1]),
                       "route_max_gap": gap, "route_near_ties_ok": ties_ok,
                       "tables_equal": tables_equal,
                       "call_equals_launch": call_equal,
                       "inactive_rows_zero": zeros}
                ok = ok and ties_ok and tables_equal and call_equal
                if kv_dtype == "fp32":
                    unquantized[dtype] = (k_idx, k_valid, pool)
                else:
                    u_idx, u_valid, u_pool = unquantized[dtype]
                    plain_u = moba_paged_attend(
                        q, u_pool["pages_k"], u_pool["pages_v"], table, kv,
                        u_idx, u_valid)
                    qerr = float((out[act].float() - plain_u[act].float())
                                 .abs().max())
                    rec.update(vs_unquantized_err=qerr,
                               vs_unquantized_tol=QUANT_TOL[kv_dtype])
                    ok = ok and qerr <= QUANT_TOL[kv_dtype]
                rec["ok"] = ok
                checks.append(rec)
                if not (ok and zeros):
                    emit({"phase": "kernel", "checks": checks})
                    raise SystemExit(f"decode kernels disagree with their "
                                     f"plain versions: {checks[-1]}")
                if name == "moba-340m" and dtype == torch.bfloat16:
                    timing[kv_dtype] = _time_decode(q, pool, table, kv, cfg,
                                                    args, err, flush)
    # per-head budgets (adaptive routing): G 1 at d 64 (moba-340m), G 2
    # at d 128 (qwen3-0.6b), G 8 at d 128 with budgets 1..200, and G 8
    # over tables shorter than top_k (npg 100 < 200) with a kv_len 0 row
    g8_short = dict(b=3, h=16, hkv=2, d=128, ps=16, npg=100,
                    num_pages=250, kv_lens=[1600, 0, 700])
    budget_checks = []
    for name, geom, cfg in (
            ("moba-340m", main, main_cfg), ("g2-d128", g2, main_cfg),
            ("g8-k200-d128", g8, MoBAConfig(block_size=16, top_k=200)),
            ("g8-short-table", g8_short,
             MoBAConfig(block_size=16, top_k=200))):
        for kv_dtype in ("fp32", "int8"):
            budget_checks.append(_check_budgets(name, geom, cfg, kv_dtype))
            if not budget_checks[-1]["ok"]:
                emit({"phase": "kernel", "budget_checks": budget_checks})
                raise SystemExit(f"the route kernel with per-head budgets "
                                 f"disagrees with its plain version: "
                                 f"{budget_checks[-1]}")
    if not all(c["union_shrank"] for c in budget_checks
               if c["geometry"] == "moba-340m"):
        raise SystemExit("per-head budgets did not shrink the union at "
                         "moba-340m's decode shape")
    timing["budgets"] = _time_budgets(main, main_cfg, flush)
    emit({"phase": "kernel", "checks": checks,
          "budget_checks": budget_checks, "timing": timing})
    bad = {k: t["profile"] for k, t in timing.items()
           if k in KV_DTYPES and (t["profile"]["port_kernels"] != 3
                                  or t["profile"]["other_device_ops"])}
    if bad:
        raise SystemExit(f"a decode call did not run exactly the 3 port "
                         f"kernels and no other device work: {bad}")
    return timing


def _profile_call(fn, attempts: int = 3) -> dict:
    """The device work of one call of ``fn`` under torch.profiler: the
    port's decode kernels (count and device µs each) and every other
    device operator.  A trace that holds no device event at all missed
    its capture (the call always launches kernels) and is taken again,
    up to ``attempts`` times; ``captures`` says how many it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for capture in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    port = [e for e in dev if "moba_decode_" in e.key]
    return {"port_kernels": sum(e.count for e in port),
            "port_kernel_us": {e.key.split("<")[0]: e.self_device_time_total
                               for e in port},
            "other_device_ops": [e.key for e in dev
                                 if "moba_decode_" not in e.key],
            "captures": capture}


def decode_library(q, pool, table, kv, idx, sel_valid):
    """The decode's library call: ``scaled_dot_product_attention`` over
    the selected pages, gathered (and dequantized) beforehand, with a
    mask of their valid tokens."""
    import torch
    from repro_torch.core import quantization as Q
    sc = _scales(pool)
    b, h, _, d = q.shape
    _, ps, hkv, _ = pool["pages_k"].shape
    phys = table.clamp(min=0).long()[
        torch.arange(b, device=q.device)[:, None, None, None, None], idx]
    heads = torch.arange(hkv, device=q.device)[None, :, None, None, None]
    kg = pool["pages_k"].permute(2, 0, 1, 3)[heads, phys]  # (B,Hkv,G,1,k,ps,d)
    vg = pool["pages_v"].permute(2, 0, 1, 3)[heads, phys]
    if sc:
        kg = Q.dequantize(kg, sc["scales_k"][phys, heads][..., None, None])
        vg = Q.dequantize(vg, sc["scales_v"][phys, heads][..., None, None])
    kg = kg.reshape(b, h, -1, d).to(q.dtype)
    vg = vg.reshape(b, h, -1, d).to(q.dtype)
    pos = idx[..., None] * ps + torch.arange(ps, device=q.device)
    mask = ((pos < kv[:, None, None, None, None, None])
            & sel_valid[..., None]).reshape(b, h, 1, -1)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask)
    return library


def _time_decode(q, pool, table, kv, cfg, args, err, flush):
    from repro_torch.core.moba import moba_paged_decode_attention as plain
    from repro_torch.core.moba import moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    sc = _scales(pool)
    cents = pool["centroids"]
    d = q.shape[-1]
    ps = pool["pages_k"].shape[1]
    idx, sel_valid = moba_paged_route(q, cents, table, kv, cfg,
                                      page_size=ps)
    tables = MD.decode_tables(q, pool["pages_k"], table, idx, sel_valid)
    scale = d ** -0.5

    def call():
        return MD.moba_paged_decode(*args, **sc)

    def launches():
        return MD.launch(q, pool["pages_k"], pool["pages_v"], cents, table,
                         kv, cfg.top_k, scale, sc.get("scales_k"),
                         sc.get("scales_v"))

    library = decode_library(q, pool, table, kv, idx, sel_valid)
    act = kv > 0
    ref = plain(*args, **sc)
    sdpa_err = float((library()[act].float() - ref[act].float()).abs().max())
    nbytes, flops = _decode_bytes_and_flops(q, pool, table, kv, idx,
                                            sel_valid, tables)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    return {**call_cost(call, flush),
            "kernel_only_ms": cuda_events_ms(launches, flush=flush),
            "kernel_only_ms_clean_l2": cuda_events_ms(launches, flush=flush,
                                                      clean=True),
            **call_cost(lambda: plain(*args, **sc), flush, "plain_"),
            **call_cost(library, flush, "library_"),
            "library_max_abs_err": sdpa_err,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err, "profile": _profile_call(call)}


# ------------------------------------------------------------------ phase 3
def _moba_layers(cfg) -> int:
    return cfg.num_layers // len(cfg.layer_pattern) * \
        cfg.layer_pattern.count("moba")


def _recording(eng, gaps: list, n_uniq: list):
    """Patches for a measured run: every decode step's top-2 logit gap
    and pre-step length per slot with the slot's request id
    (``gaps``), and every decode call's union sizes with its lengths
    (``n_uniq``: views of the call's own tables and inputs, no copy, no
    launch).  Returns the undo."""
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.models import transformer as T
    decode, launch = T.decode_step, MD._launch

    def decode_rec(params, token, cfg, caches, **kw):
        logits, caches = decode(params, token, cfg, caches, **kw)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        gaps.append(({r.slot: r.rid for r in eng.sched.running
                      if r.slot >= 0}, kw["page_state"]["kv_len"].clone(),
                     top2[:, 0] - top2[:, 1]))
        return logits, caches

    def launch_rec(*a, **kw):
        out, scratch, p = launch(*a, **kw)
        n_uniq.append((scratch[-p.rows:], a[5]))         # a[5]: kv_len
        return out, scratch, p

    T.decode_step, MD._launch = decode_rec, launch_rec

    def undo():
        T.decode_step, MD._launch = decode, launch
    return undo


def _gaps_by_token(gaps: list, reqs) -> dict:
    """rid -> {token index j: the top-2 logit gap of the decode step that
    produced token j} (token 0 comes from prefill; the step that produces
    token j starts at length prompt + j - 1)."""
    plen = {r.rid: len(r.prompt) for r in reqs}
    out = {r.rid: {} for r in reqs}
    for slots, kv, gap in gaps:
        kv, gap = kv.cpu().numpy(), gap.cpu().numpy()
        for s, rid in slots.items():
            out[rid][int(kv[s]) - plen[rid] + 1] = float(gap[s])
    return out


def phase_serve(kv_dtype: str = "fp32", new_tokens: int = 64,
                bf16_pool_bytes: int = 0, *, arch: str = "moba-340m",
                key_conv_width: int = 0, prefill_chunk: int = 0,
                prompts: int = 8, phase: str = "",
                route_policy: str = "static", backend: str = "flash",
                record: bool = False, profile: bool = True):
    """The serve cell on ``backend`` (``flash``: the decode kernels) from
    ``kv_dtype`` pools: ``arch`` (with key conv of ``key_conv_width``) at
    full width and depth, ``prompts`` requests of 1024..4095 tokens,
    routed by ``route_policy``.  ``record`` keeps each decode step's
    top-2 logit gaps and each decode call's union sizes; ``profile``
    adds the profiled window.  Returns the decode calls and the decode
    kernels' launches in the measured run, the pools' bytes and the
    record (with the streams and, if recorded, the gaps by token)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig

    phase = phase or ("serve" if kv_dtype == "fp32" else "serve_quantized")
    cfg = get_config(arch, **({"key_conv_width": key_conv_width}
                              if key_conv_width else {}))
    moba_layers = _moba_layers(cfg)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=8, max_prefill_batch=2, max_seq_len=4224,
        attn_backend=backend, kv_dtype=kv_dtype,
        prefill_chunk=prefill_chunk, route_policy=route_policy),
        device="cuda")
    pool_bytes = sum(t.numel() * t.element_size()
                     for pool in eng.caches.values() for t in pool.values())
    rng = np.random.default_rng(0)
    lens = rng.integers(1024, 4096, 8)[:prompts]
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, int(n),
                                    dtype=np.int32), max_new_tokens=new_tokens)
            for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gaps, n_uniq = [], []
    undo = _recording(eng, gaps, n_uniq) if record else None
    MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        eng.run()
        torch.cuda.synchronize()
    finally:
        if undo is not None:
            undo()
    wall = time.perf_counter() - t0
    launches, kernel_launches = MD.LAUNCHES, MD.KERNEL_LAUNCHES
    st = dict(eng.stats)           # the profile window below adds steps
    outs_ok = all(len(r.out) == new_tokens and r.done for r in reqs)
    toks = np.concatenate([np.asarray(r.out) for r in reqs])
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    rec = {"phase": phase,
           "arch": cfg.name, "dtype": cfg.dtype, "kv_dtype": kv_dtype,
           "backend": backend, "route_policy": route_policy,
           "prefill_chunk": prefill_chunk,
           "prompt_lens": [int(n) for n in lens], "new_tokens": new_tokens,
           "requests_done": sum(r.done for r in reqs),
           "prefill_tokens": st["prefill_tokens"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tokens": st["decode_tokens"],
           "decode_steps": st["decode_steps"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
           "wall_s": wall, "preemptions": st["preemptions"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "pool_bytes": pool_bytes,
           "decode_calls": launches,
           "decode_calls_per_step": launches / max(st["decode_steps"], 1),
           "kernel_launches": kernel_launches,
           "kernel_launches_per_step":
               kernel_launches / max(st["decode_steps"], 1)}
    if bf16_pool_bytes:
        rec["pool_bytes_vs_bf16"] = pool_bytes / bf16_pool_bytes
    ring = next((pool["key_conv_state"] for pool in eng.caches.values()
                 if "key_conv_state" in pool), None)
    want = (cfg.num_layers // len(cfg.layer_pattern), 8, cfg.num_kv_heads,
            key_conv_width - 1, cfg.resolved_head_dim)
    ring_ok = ring is None and not key_conv_width
    if ring is not None:
        rec["ring"] = {"shape": list(ring.shape), "dtype": str(ring.dtype),
                       "expected_shape": list(want)}
        ring_ok = tuple(ring.shape) == want and ring.dtype == torch.bfloat16
    if eng.route_profile is not None:
        rec["route_profile"] = eng.route_profile.summary()
    if n_uniq:
        rec["mean_n_uniq"] = _mean_n_uniq(*(torch.cat(x) for x in
                                            zip(*n_uniq)))
    if profile:
        rec["profile"] = _profile_decode(eng, cfg, rng)
    emit(rec)
    rec["streams"] = [list(r.out) for r in reqs]
    if record:
        rec["gaps"] = _gaps_by_token(gaps, reqs)
    # the engine sits in a reference cycle (its scheduler's preemption
    # hook), so only the collector frees its pools before the next phase
    # resets the peak-memory counter
    del eng, params, ring
    gc.collect()
    torch.cuda.empty_cache()
    what = f"{phase} ({cfg.name}, {kv_dtype}, {backend}, {route_policy})"
    if not outs_ok or not in_vocab:
        raise SystemExit(f"{what}: a request did not finish with "
                         f"{new_tokens} tokens in the vocabulary")
    # the plain backends launch no decode kernel
    if backend == "flash" and (
            launches == 0 or launches != moba_layers * st["decode_steps"]):
        raise SystemExit(f"{what}: {launches} decode calls for "
                         f"{st['decode_steps']} decode steps, expected "
                         f"{moba_layers} per step")
    if kernel_launches != 3 * launches:
        raise SystemExit(f"{what}: {kernel_launches} decode "
                         f"kernel launches for {launches} calls, expected 3 "
                         f"per call")
    if not ring_ok:
        raise SystemExit(f"{what}: the key-conv ring is missing or is not "
                         f"bf16 of shape {want}: {rec.get('ring')}")
    return launches, kernel_launches, pool_bytes, rec


def _profile_decode(eng, cfg, rng, steps: int = 6):
    """Where a decode step's time goes, after the measured run: 8 fresh
    1024-token requests staged in, then ``steps`` generate_step calls
    under torch.profiler (:func:`_profile_summary`)."""
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
    return {"batch": len(reqs), **_profile_summary(prof, wall, steps)}


def _profile_summary(prof, wall: float, steps: int) -> dict:
    """Per-step device busy time, idle share, kernel and launch counts and
    the top device and host rows of a profiled window of ``steps`` steps
    that took ``wall`` seconds.  Device busy share = summed kernel time
    over the window's wall time (one stream, so kernels do not overlap);
    the profiler's own host cost lengthens the wall time a little."""
    import torch
    avgs = prof.key_averages()
    # kernel rows only: an operator's row repeats its kernels' time
    dev = sorted(((a.key, a.self_device_time_total, a.count) for a in avgs
                  if a.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda r: -r[1])
    device_us = sum(t for _, t, _ in dev)
    host = sorted(((a.key, a.self_cpu_time_total, a.count) for a in avgs),
                  key=lambda r: -r[1])
    launch_calls = sum(c for k, _, c in host if k.startswith("cudaLaunch"))
    return {"steps": steps, "step_ms": wall / steps * 1e3,
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
LOGITS_LENS = (1500, 900, 2000, 300)      # phase 4's four sequences


def _logits_case(cfg, kv_dtype: str = "fp32", seed: int = 1):
    """fp32 weights from ``seed`` and the paged-prefill inputs of phase 4:
    four sequences of :data:`LOGITS_LENS` tokens on shuffled 128-token
    pages, each at the sequence slot of its row.  Returns (params,
    empty caches with one key-conv ring row a sequence, device inputs,
    host tokens, a caches factory)."""
    import torch
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    params = T.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)
    ps, npg = 128, 33
    lens = np.array(LOGITS_LENS, np.int32)
    b = len(lens)
    rng = np.random.default_rng(seed)
    pages = rng.permutation(b * npg)
    table = np.full((b, npg), -1, np.int32)
    for i, n in enumerate(lens):
        m = -(-(int(n) + 1) // ps)
        table[i, :m] = pages[i * npg:i * npg + m]
    tokens = np.zeros((b, 2048), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)

    def caches():
        return T.init_paged_caches(cfg, b * npg, ps, dtype=torch.float32,
                                   device=dev, kv_dtype=kv_dtype,
                                   max_seqs=b)

    t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        tokens=tokens, table=table, kv0=np.zeros(b, np.int32), lens=lens,
        slots=np.arange(b, dtype=np.int32),
        active=np.ones(b, bool)).items()}
    return params, t, tokens, caches


def _decode_flash_vs_xla(cfg, params, caches, t, first,
                         route_map=None) -> dict:
    """One decode step under ``flash`` and one under ``xla`` from clones
    of the prefilled ``caches`` (per-head budgets from ``route_map``, if
    given).  The flash run records the route kernel's selections in every
    MoBA layer; the xla run replays them, each held to xla's own routing
    by the near-tie rule (the kernel sums its fp32 dot products in
    another order than the plain einsum, so a near-tie can flip a page).
    Returns the record's fields and ``ok``."""
    import torch
    from repro_torch.core import moba as CM
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T

    moba_layers = _moba_layers(cfg)
    page_state = {"block_table": t["table"], "kv_len": t["lens"],
                  "q_len": t["active"].to(torch.int32),
                  "active": t["active"]}
    decode, plain_route = MD.moba_paged_decode, CM.moba_paged_route
    recorded, audit = [], []

    def record(q, pages_k, pages_v, centroids, table, kv, mcfg, scale=None,
               grid="grouped", scales_k=None, scales_v=None,
               head_top_k=None):
        """The decode call itself, keeping the route tables it wrote."""
        MD.check_contract(q, pages_k, pages_v, scales_k, scales_v,
                          centroids=centroids, block_table=table, kv_len=kv,
                          top_k=mcfg.top_k, head_top_k=head_top_k)
        out, rt = MD.launch(q, pages_k, pages_v, centroids, table, kv,
                            mcfg.top_k,
                            q.shape[-1] ** -0.5 if scale is None else scale,
                            scales_k, scales_v, head_top_k)
        recorded.append(rt)
        return out

    def replay(q, centroids, table, kv, mcfg, page_size=None,
               head_top_k=None):
        idx, sel_valid = plain_route(q, centroids, table, kv, mcfg,
                                     page_size=page_size,
                                     head_top_k=head_top_k)
        rt = recorded[len(audit)]
        audit.append(_route_near_ties(q, centroids, table, kv, page_size,
                                      rt.sel, idx, sel_valid))
        return _kernel_selection(rt, q, centroids)

    def clone():
        return {s: {k: v.clone() for k, v in pool.items()}
                for s, pool in caches.items()}

    logits, toks = {}, {}
    try:
        for backend in ("flash", "xla"):
            MD.moba_paged_decode, CM.moba_paged_route = (
                (record, plain_route) if backend == "flash"
                else (decode, replay))
            lg, _ = T.decode_step(params, first[:, None], cfg, clone(),
                                  backend=backend, page_state=page_state,
                                  route_map=route_map)
            step_tok, _ = S.make_paged_decode_step(
                cfg, backend, route_map=route_map)(
                params, first, clone(), t["table"], t["lens"], t["active"])
            logits[backend] = lg[:, -1]
            toks[backend] = step_tok
    finally:
        MD.moba_paged_decode, CM.moba_paged_route = decode, plain_route
    torch.cuda.synchronize()
    routing_ok = (len(audit) == len(recorded) == 2 * moba_layers
                  and all(ok for _, _, ok in audit))
    diff = float((logits["flash"] - logits["xla"]).abs().max())
    close = bool(torch.allclose(logits["flash"], logits["xla"], atol=2e-3,
                                rtol=2e-3))
    finite = bool(torch.isfinite(logits["flash"]).all())
    same = bool(torch.equal(toks["flash"], toks["xla"])
                and torch.equal(toks["flash"],
                                logits["flash"].argmax(-1).to(torch.int32)))
    return {"vocab": cfg.vocab_size, "max_abs_diff": diff, "tol": 2e-3,
            "allclose": close, "finite": finite, "greedy_equal": same,
            "routing_rows_differing_per_layer": [r for r, _, _ in audit],
            "routing_max_gap": max((g for _, g, _ in audit), default=0.0),
            "routing_near_ties_ok": routing_ok,
            "ok": close and finite and same and routing_ok}


def phase_logits(kv_dtype: str = "fp32", arch: str = "moba-340m",
                 phase: str = "logits", nonuniform: bool = False):
    """flash against xla for one decode step in fp32 after one shared
    paged prefill (:func:`_decode_flash_vs_xla`); ``nonuniform`` routes
    both (and the prefill) by :func:`nonuniform_profile`'s budgets."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    rmap = (S.as_route_map(nonuniform_profile(cfg).route_map(), "cuda")
            if nonuniform else None)
    params, t, _, new_caches = _logits_case(cfg, kv_dtype)
    first, caches = S.make_paged_prefill_step(
        cfg, "xla", chunked=True, route_map=rmap)(
        params, t["tokens"], new_caches(), t["table"], t["kv0"], t["lens"],
        t["slots"], t["active"])
    rec = _decode_flash_vs_xla(cfg, params, caches, t, first, rmap)
    emit({"phase": phase, "arch": cfg.name, "dtype": "float32",
          "kv_dtype": kv_dtype, "batch": len(LOGITS_LENS),
          "kv_lens": list(LOGITS_LENS), "nonuniform_profile": nonuniform,
          **rec})
    del params, caches
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise SystemExit(f"{phase} ({kv_dtype}): flash and xla decode steps "
                         f"disagree, or a routing difference is no "
                         f"near-tie")


# ------------------------------------------------------- adaptive routing
# a top-2 gap of the bf16 decode logits at or below which two backends'
# greedy streams may part: 4 bf16 steps at logits in [2, 4)
BF16_GAP_TOL = 0.0625


def nonuniform_profile(cfg):
    """The routing profile the card serves to make truncation bite:
    ``RoutingProfile.uniform(cfg)`` with every other head at budget 1
    (its own page only) and the rest cycling through 2..top_k."""
    from repro_torch.core import adaptive as AD
    prof = AD.RoutingProfile.uniform(cfg)
    k = prof.k_max
    for arr in prof.top_k.values():
        flat = arr.reshape(-1)
        for i in range(flat.size):
            flat[i] = 1 if i % 2 == 0 else min(2 + (i // 2) % max(k - 1, 1),
                                               k)
    return prof


def _streams_vs(a: dict, b: dict) -> dict:
    """Greedy streams of two serve records: where each request first
    parts, and whether every parting is at a near-tie (the top-2 gap of
    either run's logits at that token at most :data:`BF16_GAP_TOL`)."""
    parted, explained = [], True
    for rid, (sa, sb) in enumerate(zip(a["streams"], b["streams"])):
        j = next((j for j, (x, y) in enumerate(zip(sa, sb)) if x != y),
                 None)
        if j is None:
            continue
        gap = min(a["gaps"][rid].get(j, np.inf),
                  b["gaps"][rid].get(j, np.inf))
        parted.append({"request": rid, "token": j, "gap": gap})
        explained &= gap <= BF16_GAP_TOL
    return {"streams_equal": len(a["streams"]) - len(parted),
            "parted": parted, "gap_tol": BF16_GAP_TOL,
            "near_ties_ok": explained}


def phase_serve_adaptive():
    """moba-340m at full width (bf16) with SNR-guided adaptive routing on
    ``flash``: phase 3's prompts, 32 new tokens, under static routing,
    (a) ``snr:pfail=0.01`` calibrated at engine build, and (b) the
    non-uniform :func:`nonuniform_profile` loaded from a file, then (b)
    on ``xla`` and (b) from an int8 pool; then phase 4's fp32 flash vs
    xla decode check under (b).  Gates under (b): every request
    finishes, 12 decode calls and 36 kernels a step, the launch calls of
    a profiled step equal static's, the stream differs from static's,
    flash and xla streams part only at near-ties.  Returns the decode
    calls and kernel launches of (b)'s flash run and the record."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import adaptive as AD

    cfg = get_config("moba-340m")
    n = QUANT_NEW_TOKENS
    runs = {"static": phase_serve("fp32", n, phase="serve_adaptive",
                                  record=True)[3]}
    calibrate, calib = AD.calibrate_profile, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = calibrate(*a, **kw)
        torch.cuda.synchronize()
        calib.append(time.perf_counter() - t0)
        return prof

    AD.calibrate_profile = timed
    try:
        runs["snr"] = phase_serve("fp32", n, phase="serve_adaptive",
                                  route_policy="snr:pfail=0.01",
                                  record=True, profile=False)[3]
    finally:
        AD.calibrate_profile = calibrate
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "routing_profile.json")
        nonuniform_profile(cfg).save(path)
        policy = f"profile:{path}"
        calls, kernels, _, runs["b"] = phase_serve(
            "fp32", n, phase="serve_adaptive", route_policy=policy,
            record=True)
        runs["b_xla"] = phase_serve("fp32", n, phase="serve_adaptive",
                                    route_policy=policy, backend="xla",
                                    record=True, profile=False)[3]
        int8 = phase_serve("int8", n, phase="serve_adaptive",
                           route_policy=policy, profile=False)
    phase_logits(phase="serve_adaptive_logits", nonuniform=True)
    st, b = runs["static"], runs["b"]
    vs_xla = _streams_vs(b, runs["b_xla"])
    differs = b["streams"] != st["streams"]
    same_launch_calls = (b["profile"]["launch_calls_per_step"]
                         == st["profile"]["launch_calls_per_step"])
    rec = {"phase": "serve_adaptive", "arch": cfg.name,
           "new_tokens": n, "calibration_s": calib,
           "snr_profile": runs["snr"]["route_profile"],
           "snr_streams_equal_static": runs["snr"]["streams"]
           == st["streams"],
           "b_profile": b["route_profile"],
           "b_int8_decode_calls_per_step": int8[3]["decode_calls_per_step"],
           "b_differs_from_static": differs,
           "b_flash_vs_xla": vs_xla,
           "launch_calls_per_step_equal_static": same_launch_calls,
           "compare": {name: {
               "decode_step_ms": r["profile"]["step_ms"],
               "device_busy_ms": r["profile"]["device_busy_ms_per_step"],
               "device_idle_share": r["profile"]["device_idle_share"],
               "launch_calls_per_step":
                   r["profile"]["launch_calls_per_step"],
               "run_decode_step_ms": r["decode_step_ms"],
               "mean_n_uniq": r["mean_n_uniq"]}
               for name, r in (("static", st), ("b", b))},
           "snr_mean_n_uniq": runs["snr"]["mean_n_uniq"]}
    emit(rec)
    if not (differs and vs_xla["near_ties_ok"] and same_launch_calls
            and len(calib) == 1):
        raise SystemExit("serve_adaptive: the non-uniform profile did not "
                         "change the stream, flash and xla parted off a "
                         "near-tie, a step's launch calls differ from "
                         "static's, or calibration did not run once")
    return calls, kernels, rec


# ------------------------------------------------------- key-conv logits
KEY_CONV_WIDTH = 3                          # the paper's kconv3
GAP_TOL = 1e-3          # a top-2 logit gap at or below which a greedy
#                         stream may part from another path's (fp32)


def phase_key_conv_logits(chunk: int = 1000):
    """moba-340m-kconv3 in fp32 (TF32 off), phase 4's sequences: a
    chunked prefill (chunks of ``chunk``) whose rings must hold each
    sequence's last W-1 raw keys bit for bit (recomputed one-shot from
    the raw keys every chunk computed), pools within 2e-4 of a one-shot
    prefill's, then :func:`_decode_flash_vs_xla` from the chunked caches;
    then the swap check (:func:`_key_conv_swap`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import key_conv as KC
    from repro_torch.launch import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        get_config("moba-340m", key_conv_width=KEY_CONV_WIDTH),
        dtype="float32")
    groups = cfg.num_layers // len(cfg.layer_pattern)
    params, t, tokens, new_caches = _logits_case(cfg)
    step = S.make_paged_prefill_step(cfg, "flash", chunked=True)
    _, one = step(params, t["tokens"], new_caches(), t["table"], t["kv0"],
                  t["lens"], t["slots"], t["active"])
    conv, raw, takes = KC.apply_key_conv_with_state, [], []

    def recording(weights, k, state):
        raw.append(k.clone())
        return conv(weights, k, state)

    lens = np.array(LOGITS_LENS, np.int32)
    b = len(lens)
    chunked = new_caches()
    first = torch.zeros(b, dtype=torch.int32, device=dev)
    KC.apply_key_conv_with_state = recording
    try:
        for s0 in range(0, int(lens.max()), chunk):
            q = np.clip(lens - s0, 0, chunk).astype(np.int32)
            kv = np.minimum(lens, s0).astype(np.int32)
            dv = {k: torch.as_tensor(v, device=dev) for k, v in dict(
                tok=np.ascontiguousarray(tokens[:, s0:s0 + chunk]), q=q,
                kv=kv, active=q > 0, last=(q > 0) & (kv + q == lens)).items()}
            out, chunked = step(params, dv["tok"], chunked, t["table"],
                                dv["kv"], dv["q"], t["slots"], dv["active"])
            first = torch.where(dv["last"], out, first)
            takes.append(q)
    finally:
        KC.apply_key_conv_with_state = conv
    torch.cuda.synchronize()
    # the rings against the last W-1 of the raw keys the chunks computed
    ring_equal = len(raw) == groups * len(takes)
    for g in range(groups):
        full = torch.zeros((b, cfg.num_kv_heads, int(lens.max()),
                            cfg.resolved_head_dim), device=dev)
        for c, q in enumerate(takes):
            k = raw[c * groups + g]
            for i in range(b):
                full[i, :, c * chunk:c * chunk + q[i]] = k[i, :, :q[i]]
        want = KC.key_conv_state_update(
            torch.zeros_like(full[:, :, :KEY_CONV_WIDTH - 1]), full,
            t["lens"])
        ring_equal &= bool(torch.equal(
            chunked["slot_1"]["key_conv_state"][g], want))
    del raw
    pools = {f"{sname}/{leaf}": float((x - one[sname][leaf]).abs().max())
             for sname, pool in chunked.items() for leaf, x in pool.items()}
    pools_close = all(
        bool(torch.allclose(x, one[sname][leaf], atol=2e-4, rtol=2e-4))
        for sname, pool in chunked.items() for leaf, x in pool.items()
        if leaf in ("pages_k", "pages_v", "centroids"))
    del one
    torch.cuda.empty_cache()
    rec = _decode_flash_vs_xla(cfg, params, chunked, t, first)
    del params, chunked
    torch.cuda.empty_cache()
    swap = _key_conv_swap()
    ok = ring_equal and pools_close and rec["ok"] and swap["ok"]
    emit({"phase": "key_conv_logits", "arch": cfg.name, "dtype": "float32",
          "batch": b, "kv_lens": list(LOGITS_LENS), "prefill_chunk": chunk,
          "rings_equal_last_raw_keys": ring_equal,
          "chunked_vs_one_shot_max_abs": pools,
          "pools_within_2e-4": pools_close, "decode": rec, "swap": swap,
          "ok": ok})
    if not ok:
        raise SystemExit("key_conv_logits: a ring is not the last raw "
                         "keys, chunked and one-shot pools differ, flash "
                         "and xla disagree, or the swap check failed")


def _key_conv_swap(layers: int = 4, new_tokens: int = 32) -> dict:
    """Swap preemption under key conv at full width, depth cut to
    ``layers`` (fp32): four prompts just under a page boundary in a pool
    of one page more than they take, so growing past it preempts by
    swap.  Every restored ring row must equal its snapshot bit for bit,
    and each greedy stream equal the stream of an engine with room for
    all up to its first step whose top-2 logit gap (teacher-forced,
    ``reference``) is at most :data:`GAP_TOL`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import paged_cache as PC
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(
        get_config("moba-340m", key_conv_width=KEY_CONV_WIDTH),
        dtype="float32", num_layers=layers)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(2), cfg)
    rng = np.random.default_rng(2)
    lens = (1020, 1010, 1015, 1000)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in lens]
    scatter, restored = PC.scatter_ring_rows, []

    def checked(caches, slot, data):
        caches = scatter(caches, slot, data)
        restored.append(all(
            torch.equal(caches[s][leaf][:, slot].cpu(), x)
            for (s, leaf), x in data.items()))
        return caches

    outs, stats = {}, {}
    for name, pages in (("roomy", 0), ("tight", 33)):
        eng = Engine(cfg, params, EngineConfig(
            max_seqs=4, max_seq_len=1152, num_pages=pages,
            attn_backend="flash"), device="cuda")
        reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        PC.scatter_ring_rows = checked
        try:
            eng.run()
        finally:
            PC.scatter_ring_rows = scatter
        outs[name] = [list(r.out) for r in reqs]
        stats[name] = {k: eng.stats[k] for k in (
            "preemptions", "swap_saves", "swap_restores", "decode_steps")}
        del eng
        gc.collect()               # as in phase_serve
    # teacher-forced top-2 gaps along the roomy streams
    first_tie, ties, diverged, explained = [], 0, 0, True
    for p, want, got in zip(prompts, outs["roomy"], outs["tight"]):
        seq = torch.as_tensor(np.concatenate([p, want[:-1]]),
                              device="cuda")[None]
        with torch.no_grad():
            lg, _, _ = T.lm_apply(params, seq, cfg, backend="reference")
        top2 = lg[0, len(p) - 1:].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        tie = next((j for j, g in enumerate(gaps) if g <= GAP_TOL), None)
        ties += int((gaps <= GAP_TOL).sum())
        first_tie.append(tie)
        d = next((j for j, (a, c) in enumerate(zip(want, got)) if a != c),
                 None)
        if d is not None:
            diverged += 1
            explained &= tie is not None and tie <= d
    ok = (stats["tight"]["swap_restores"] > 0 and bool(restored)
          and all(restored) and stats["roomy"]["preemptions"] == 0
          and explained)
    return {"num_layers": layers, "prompt_lens": list(lens),
            "new_tokens": new_tokens, "stats": stats,
            "ring_restores_checked": len(restored),
            "ring_restores_equal": sum(restored),
            "streams_equal": sum(a == c for a, c in zip(outs["roomy"],
                                                       outs["tight"])),
            "streams_diverged": diverged, "near_tie_steps": ties,
            "first_near_tie_step": first_tie, "gap_tol": GAP_TOL, "ok": ok}


# ------------------------------------------------------------------ phase 5
def _bound(nbytes: float, flops: float, flops_rate: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_rate * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _max_rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _topk_case(*, h, hkv, n, nq, d, dtype, seed, bs=128, top_k=8,
               tile=128):
    """Random q, k, v on the card, the centroids and the plain routing."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    q, k, v = rnd(1, h, nq, d, scale=0.5), rnd(1, hkv, n, d, scale=0.5), \
        rnd(1, hkv, n, d)
    g = h // hkv
    kf = k.reshape(hkv, n, d)
    cents = ref.centroids_ref(kf, bs)
    tile = min(tile, nq)
    qf = ops.padded_queries(q, tile)
    sel = ref.flash_topk_ref(qf, cents, top_k, bs, group=g, num_q_heads=h,
                             q_pos_offset=n - nq)
    return dict(q=q, k=k, v=v, kf=kf, cents=cents, qf=qf, sel=sel,
                tile=tile, top_k=top_k, bs=bs, nb=-(-n // bs), g=g, h=h,
                n=n, nq=nq, gen=gen)


def _train_case(**kw):
    """``_topk_case`` and the sorted layout built from its routing, as
    ``kernels/ops.py`` builds it."""
    from repro_torch.kernels import ops
    c = _topk_case(**kw)
    n, bs = c["n"], c["bs"]
    lay, q_sorted, q_pos = ops.sorted_layout(c["qf"], c["sel"], c["nq"],
                                             c["nb"], c["tile"], n - c["nq"])
    c.update(lay=lay, q_sorted=q_sorted, q_pos=q_pos,
             k_blocks=ops.flatten_kv_blocks(c["k"], bs)[0],
             v_blocks=ops.flatten_kv_blocks(c["v"], bs)[0],
             kw=dict(scale=c["q"].shape[-1] ** -0.5, block_size=bs,
                     n_tokens=n, num_q_heads=c["h"], group=c["g"]))
    return c


def _masked_scores(q_rows, cent_rows, n: int, bs: int):
    """Plain causal routing scores of queries q_rows (BH, Nq, d), the
    suffix of n keys, against cent_rows (BH, nb, d): future blocks -1e30,
    the own block +1e30, and a sentinel column nb at -1e30."""
    import torch
    from repro_torch.core import routing
    nq = q_rows.shape[1]
    scores = routing.routing_scores(q_rows, cent_rows)       # (BH, Nq, nb)
    own = (torch.arange(nq, device=q_rows.device) + n - nq) // bs
    blk = torch.arange(scores.shape[-1], device=q_rows.device)
    masked = torch.where(blk[None] > own[:, None], routing.NEG_INF, scores)
    masked = torch.where(blk[None] == own[:, None], routing.POS_INF, masked)
    return torch.cat([masked, torch.full_like(masked[..., :1],
                                              routing.NEG_INF)], dim=-1)


def _near_ties(masked, sel, ref_sel):
    """Rows where selection ``sel`` differs from the plain ``ref_sel``, and
    the largest gap between the two rows' sorted selected scores.  A
    difference is a near-tie when every gap is <= 1e-5·max(1, |s|)."""
    got = masked.gather(-1, sel.long()).sort(-1, descending=True).values
    want = masked.gather(-1, ref_sel.long()).sort(-1,
                                                  descending=True).values
    gap = (got - want).abs()
    return (int((sel != ref_sel).any(-1).sum()), float(gap.max()),
            bool((gap <= 1e-5 * want.abs().clamp(min=1.0)).all()))


def _topk_near_ties(c, s_k):
    """Flash TopK's selection on case ``c`` against the plain routing."""
    from repro_torch.kernels import ref
    nq = c["nq"]
    qf = c["qf"][:, :nq]
    kv = ref.kv_rows(qf.shape[0], c["h"], c["g"], qf.device)
    masked = _masked_scores(qf, c["cents"][kv], c["n"], c["bs"])
    return _near_ties(masked, s_k[:, :nq], c["sel"][:, :nq])


def _do_dtype(KB, c):
    """The dO dtype the backward wrapper ``KB`` takes on case ``c``: q's
    where its ``check_contract`` accepts that (the tensor-core backward),
    else fp32 (the trees before it)."""
    import torch
    qs, lse = c["q_sorted"], torch.zeros(c["q_pos"].shape, device="cuda")
    try:
        KB.check_contract(qs, qs, lse, lse, c["k_blocks"], c["v_blocks"],
                          c["lay"].tile_block, c["q_pos"], c["tile"], c["h"],
                          c["g"])
    except ValueError:
        return torch.float32
    return qs.dtype


def _check_flash_topk(c) -> dict:
    """Flash TopK on case ``c`` against the plain routing."""
    from repro_torch.kernels import flash_topk as KT
    s_k = KT.flash_topk(c["qf"], c["cents"], c["top_k"], c["bs"],
                        group=c["g"], num_q_heads=c["h"],
                        q_pos_offset=c["n"] - c["nq"], q_tile=c["tile"])
    rows, gap, ok = _topk_near_ties(c, s_k)
    return {"rows_differing": rows, "rows": s_k.shape[0] * c["nq"],
            "max_abs_err": gap, "ok": ok}


def _check_train_kernels(c, dtype) -> dict:
    """Each training kernel against its plain version on case ``c``."""
    import torch
    from repro_torch.kernels import centroids as KC, flash_topk as KT
    from repro_torch.kernels import moba_bwd as KB, moba_fwd as KF, ref
    bf16 = dtype == torch.bfloat16
    lay, kw = c["lay"], c["kw"]
    rec = {}
    cent = KC.block_centroids_kernel(c["kf"], c["bs"])
    tol = 1e-2 if bf16 else 1e-5
    rec["block_centroids"] = {
        "max_abs_err": float((cent.float() - c["cents"].float()).abs().max()),
        "tol": tol, "ok": bool(torch.allclose(cent.float(),
                                              c["cents"].float(), atol=tol,
                                              rtol=tol))}
    rec["flash_topk"] = _check_flash_topk(c)
    args = (lay.tile_block, c["q_sorted"], c["q_pos"], c["k_blocks"],
            c["v_blocks"])
    o_k = KF.moba_fwd(*args, q_tile=c["tile"], **kw)
    o_p = ref.moba_partials_ref(*args, **kw)
    tol = 3e-2 if bf16 else 2e-4
    rec["moba_fwd"] = {
        "max_abs_err": max(float((a - b).abs().max())
                           for a, b in zip(o_k, o_p)),
        "tol": tol, "ok": all(bool(torch.allclose(a, b, atol=tol, rtol=tol))
                              for a, b in zip(o_k, o_p))}
    # per-slot lse of the slot's own partial keeps p <= 1
    lse = (o_p[1].clamp(min=-5e29)
           + torch.log(o_p[2].clamp(min=1e-30)))
    do = torch.randn(c["q_sorted"].shape, generator=c["gen"],
                     device="cuda").to(_do_dtype(KB, c))
    delta = torch.randn(lse.shape, generator=c["gen"], device="cuda") * 0.1
    bargs = (lay.tile_block, c["q_sorted"], c["q_pos"], do, lse, delta,
             c["k_blocks"], c["v_blocks"])
    g_k = KB.moba_bwd(*bargs, q_tile=c["tile"], **kw)
    g_again = KB.moba_bwd(*bargs, q_tile=c["tile"], **kw)
    g_p = ref.moba_bwd_ref(*bargs, **kw)
    tol = 3e-2 if bf16 else 5e-3
    rels = [_max_rel(a, b) for a, b in zip(g_k, g_p)]
    same = all(bool(torch.equal(a, b)) for a, b in zip(g_k, g_again))
    rec["moba_bwd"] = {
        "max_abs_err": max(float((a - b).abs().max())
                           for a, b in zip(g_k, g_p)),
        "max_rel_err": max(rels), "tol": tol, "do_dtype": str(do.dtype),
        "bit_equal_rerun": same, "ok": max(rels) <= tol and same}
    c.update(o_p=o_p, do=do, lse=lse, delta=delta)
    return rec


def _time_train_kernels(c, flush) -> dict:
    """Kernel alone, wrapper and plain version of each training kernel on
    case ``c`` (CUDA-event medians), with bytes, FLOPs and the bound from
    this case's tensors, and a library call where one exists."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import centroids as KC
    from repro_torch.kernels import moba_bwd as KB, moba_fwd as KF, ref
    lay, kw, tile, bs, d = c["lay"], c["kw"], c["tile"], c["bs"], \
        c["q"].shape[-1]
    rate = BF16_FLOPS if c["q"].dtype == torch.bfloat16 else FP32_FLOPS
    active = lay.tile_block < c["nb"]
    n_active = int(active.sum())
    kv = ref.kv_rows(lay.tile_block.shape[0], c["h"], c["g"], "cuda")
    # each (kv row, visited block) pair's K and V read once
    pairs = torch.unique((kv[:, None] * (c["nb"] + 1)
                          + lay.tile_block.long())[active]).numel()
    kv_bytes = 2 * pairs * bs * d * c["k"].element_size()
    out = {}

    def timed(name, kernel, wrapper, plain, bound, library=None,
              yardstick=None):
        out[name] = {**call_cost(wrapper, flush),
                     "kernel_only_ms": cuda_events_ms(kernel, flush=flush),
                     **call_cost(plain, flush, "plain_"),
                     **(call_cost(library, flush, "library_") if library
                        else {"library_ms": None}), **bound}
        if yardstick:
            out[name]["sdpa_yardstick_ms"] = cuda_events_ms(yardstick,
                                                            flush=flush)

    kf, nb = c["kf"], c["nb"]
    cent = c["cents"]

    def mean():
        return kf.view(kf.shape[0], nb, bs, d).mean(2)

    timed("block_centroids", lambda: KC.launch(kf, bs),
          lambda: KC.block_centroids_kernel(kf, bs),
          lambda: ref.centroids_ref(kf, bs),
          _bound(_nbytes(kf, cent), kf.numel(), FP32_FLOPS), library=mean)
    out["block_centroids"]["kernel_only_ms_clean_l2"] = cuda_events_ms(
        lambda: KC.launch(kf, bs), flush=flush, clean=True)
    # the kernel and the library mean under each placement of the spin
    out["block_centroids"]["by_hold"] = {
        f"{what}_{hold}": cuda_events_ms(fn, flush=flush, hold=hold)
        for what, fn in (("kernel", lambda: KC.launch(kf, bs)),
                         ("library", mean))
        for hold in ("first", "after_flush", "none")}
    out["flash_topk"] = _time_flash_topk(c, flush)
    args = (lay.tile_block, c["q_sorted"], c["q_pos"], c["k_blocks"],
            c["v_blocks"])
    fkw = {k: v for k, v in kw.items() if k != "block_size"}
    o, m, l = c["o_p"]
    q4 = c["q"]
    k4 = c["k"].repeat_interleave(c["g"], dim=1)
    v4 = c["v"].repeat_interleave(c["g"], dim=1)
    timed("moba_fwd",
          lambda: KF.launch(*args, q_tile=tile, kb_tile=min(bs, 128),
                            causal=True, **fkw),
          lambda: KF.moba_fwd(*args, q_tile=tile, **kw),
          lambda: ref.moba_partials_ref(*args, **kw),
          _bound(_nbytes(lay.tile_block, c["q_sorted"], c["q_pos"], o, m, l)
                 + kv_bytes, 4.0 * n_active * tile * bs * d, rate),
          yardstick=lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True))
    tables = KB.segments(lay.tile_block, nb)
    bargs = (c["q_sorted"], c["q_pos"], c["do"], c["lse"], c["delta"],
             c["k_blocks"], c["v_blocks"])
    grad_bytes = 4 * (c["do"].numel()                         # dq, fp32
                      + 2 * lay.tile_block.shape[0] * nb * bs * d)  # dk, dv
    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_g = torch.randn_like(sdpa_out)
    timed("moba_bwd",
          lambda: KB.launch(tables, *bargs, q_tile=tile, causal=True,
                            **fkw),
          lambda: KB.moba_bwd(lay.tile_block, *bargs, q_tile=tile, **kw),
          lambda: ref.moba_bwd_ref(lay.tile_block, *bargs, **kw),
          _bound(_nbytes(*tables, *bargs[:5]) + grad_bytes + kv_bytes,
                 10.0 * n_active * tile * bs * d, rate),
          yardstick=lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg),
                                                sdpa_g, retain_graph=True))
    # the launch alone with runs cut into segments of 4, 8 and 16 tiles
    out["moba_bwd"]["kernel_only_ms_by_run_tiles"] = {
        rt: cuda_events_ms(lambda t=KB.segments(lay.tile_block, nb, rt):
                           KB.launch(t, *bargs, q_tile=tile, causal=True,
                                     **fkw), flush=flush)
        for rt in (4, 8, 16)}
    out["moba_bwd"]["run_tiles"] = KB.RUN_TILES
    return out


def _time_flash_topk(c, flush, full: bool = True, reps: int = 25) -> dict:
    """Flash TopK on case ``c``: the launch alone (median of ``reps``), the
    bound (bytes: q, centroids and the ids once; FLOPs: 2·d a scored
    (query, block) pair); with ``full``, also ``call_cost`` of the wrapper
    and of the plain version, and as a yardstick — not the same function:
    ``torch.topk`` promises no tie order — ``torch.topk`` over the masked
    ``torch.bmm`` scores."""
    import torch
    from repro_torch.kernels import flash_topk as KT, ref
    qf, cent, bs, tk, nb = c["qf"], c["cents"], c["bs"], c["top_k"], c["nb"]
    d = qf.shape[-1]
    off = c["n"] - c["nq"]
    rate = BF16_FLOPS if qf.dtype == torch.bfloat16 else FP32_FLOPS
    # the kernel scores every block before the query's own (causal)
    pos = torch.arange(qf.shape[1], device="cuda") + off
    own = pos // bs
    scored = float(own.clamp(max=nb).sum()) * qf.shape[0]
    rec = {"kernel_only_ms": cuda_events_ms(lambda: KT.launch(
               qf, cent, tk, bs, group=c["g"], causal=True,
               q_pos_offset=off), reps=reps, flush=flush),
           "shape": {"bh": qf.shape[0], "nq": qf.shape[1], "nb": nb,
                     "d": d, "block_size": bs, "top_k": tk,
                     "dtype": str(qf.dtype)},
           **_bound(_nbytes(qf, cent, c["sel"]), 2 * d * scored, rate)}
    if not full:
        return rec
    cent_rows = cent[ref.kv_rows(qf.shape[0], c["h"], c["g"], "cuda")]
    blk = torch.arange(nb, device="cuda")
    future, is_own = blk[None] > own[:, None], blk[None] == own[:, None]

    def yardstick():
        sc = torch.bmm(qf, cent_rows.transpose(1, 2)).float()
        sc = sc.masked_fill(future, float("-inf")).masked_fill(
            is_own, float("inf"))
        return torch.topk(sc, min(tk, nb), dim=-1)

    return {**call_cost(lambda: KT.flash_topk(
                qf, cent, tk, bs, group=c["g"], num_q_heads=c["h"],
                q_pos_offset=off, q_tile=c["tile"]), flush),
            **rec,
            **call_cost(lambda: ref.flash_topk_ref(
                qf, cent, tk, bs, group=c["g"], num_q_heads=c["h"],
                q_pos_offset=off), flush, "plain_"),
            "library_ms": None,
            **call_cost(yardstick, flush, "topk_yardstick_")}


def _flash_vs_xla(c) -> dict:
    """``flash_moba`` forward and grads against the ``xla`` path on case
    ``c`` (fp32).  Rows whose Flash TopK routing differs from the plain
    routing (near-ties) get a zero upstream gradient and are left out of
    the forward comparison, so both sides see the same function."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.kernels import flash_topk as KT, ops, ref
    cfg = MoBAConfig(block_size=c["bs"], top_k=c["top_k"])
    b, h, nq, d = c["q"].shape
    s_k = KT.flash_topk(c["qf"], c["cents"], c["top_k"], c["bs"],
                        group=c["g"], num_q_heads=h,
                        q_pos_offset=c["n"] - nq, q_tile=c["tile"])
    same = ~(s_k[:, :nq] != c["sel"][:, :nq]).any(-1)        # (BH, Nq)
    same = same.reshape(b, h, nq, 1)
    g_out = torch.randn(c["q"].shape, generator=c["gen"],
                        device="cuda") * same
    res = {}
    for name, fn in (("flash", ops.flash_moba), ("xla", ref.moba_sparse_xla)):
        qkv = [x.detach().requires_grad_() for x in (c["q"], c["k"], c["v"])]
        o = fn(*qkv, cfg)
        res[name] = (o.detach(), torch.autograd.grad(o, qkv, g_out))
    (o_f, g_f), (o_x, g_x) = res["flash"], res["xla"]
    fwd_err = float(((o_f - o_x) * same).abs().max())
    rels = [_max_rel(a, b) for a, b in zip(g_f, g_x)]
    return {"rows_left_out": int((~same).sum()), "fwd_max_abs_err": fwd_err,
            "grad_max_rel_err": max(rels), "fwd_tol": 2e-4, "grad_tol": 5e-3,
            "ok": fwd_err <= 2e-4 + 2e-4 * float(o_x.abs().max())
            and max(rels) <= 5e-3}


def _time_flash_moba(c, flush) -> dict:
    """``flash_moba`` forward and forward+backward against causal SDPA at
    the same shape (a yardstick: dense attention, not the same
    function)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.kernels import ops
    cfg = MoBAConfig(block_size=c["bs"], top_k=c["top_k"])
    g = c["g"]
    qkv = [x.detach().requires_grad_() for x in (c["q"], c["k"], c["v"])]
    dense = [x.detach().requires_grad_() for x in (
        c["q"], c["k"].repeat_interleave(g, 1),
        c["v"].repeat_interleave(g, 1))]
    grad = torch.randn_like(c["q"])

    def fwd_bwd(fn, xs):
        torch.autograd.grad(fn(*xs), xs, grad)

    with torch.no_grad():
        fwd = cuda_events_ms(lambda: ops.flash_moba(c["q"], c["k"], c["v"],
                                                    cfg), flush=flush)
        sdpa = cuda_events_ms(lambda: F.scaled_dot_product_attention(
            *dense, is_causal=True), flush=flush)
    return {"flash_moba_fwd_ms": fwd,
            "flash_moba_fwd_bwd_ms": cuda_events_ms(
                lambda: fwd_bwd(lambda *x: ops.flash_moba(*x, cfg), qkv),
                flush=flush),
            "sdpa_causal_fwd_ms_yardstick": sdpa,
            "sdpa_causal_fwd_bwd_ms_yardstick": cuda_events_ms(
                lambda: fwd_bwd(lambda *x: F.scaled_dot_product_attention(
                    *x, is_causal=True), dense), flush=flush)}


def _tensor_core_audit(phase: str, libs) -> dict:
    """Per kernel function of the built libraries ``libs``: registers and
    stack bytes (``cuobjdump -res-usage``; a spill needs a stack frame)
    and the count of tensor-core instructions in its SASS
    (``HMMA``/``HGMMA``, ``cuobjdump -sass``).  Fails if a bf16
    instantiation (``*_mma<D, ...>``, or ``flash_topk_kernel<bf16,
    ...>``) has none, if an ``*_mma`` one has a stack frame at d 64, or
    if a library shows no bf16 instantiation."""
    import re
    from repro_torch.kernels import runtime
    tool = os.path.join(os.path.dirname(runtime.nvcc_path()), "cuobjdump")
    funcs = {}
    for lib in libs:
        path = str(runtime.library_path(lib))
        for flag in ("-res-usage", "-sass"):
            text = subprocess.run([tool, flag, path], capture_output=True,
                                  text=True, timeout=300, check=True).stdout
            cur = None
            for ln in text.splitlines():
                m = re.search(r"Function\s*:?\s*(\w+)", ln)
                if m:
                    cur = funcs.setdefault(m.group(1), {"library": lib,
                                                        "tensor_core": 0})
                    continue
                m = re.search(r"REG:(\d+) STACK:(\d+)", ln)
                if m and cur is not None:
                    cur["registers"] = int(m.group(1))
                    cur["stack_bytes"] = int(m.group(2))
                if flag == "-sass" and cur is not None and \
                        re.search(r"\bHG?MMA\b", ln):
                    cur["tensor_core"] += 1
    bf16 = {n: f for n, f in funcs.items()
            if re.search(r"_mmaILi\d+E|flash_topk_kernelI13__nv_bfloat16", n)}
    bad = [n for n, f in bf16.items()
           if not f["tensor_core"] or (
               re.search(r"_mmaILi64E", n) and f.get("stack_bytes", 1) != 0)]
    rec = {"functions": funcs, "bf16_functions": len(bf16),
           "ok": {f["library"] for f in bf16.values()} == set(libs)
           and not bad}
    if not rec["ok"]:
        emit({"phase": phase, "tensor_core_audit": rec})
        raise SystemExit(f"{phase}: a bf16 kernel of {list(libs)} has no "
                         f"tensor-core instruction, or an mma one spills at "
                         f"d 64 (or none was found): {bad or sorted(funcs)}")
    return rec


def phase_train_kernels():
    import torch
    audit = _tensor_core_audit("train_kernels",
                               ("flash_topk", "moba_fwd", "moba_bwd"))
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    geoms = [("moba-340m", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                                d=64), (torch.bfloat16, torch.float32)),
             ("g2-d128", dict(h=16, hkv=8, n=4096, nq=4096, d=128),
              (torch.bfloat16, torch.float32)),
             ("ragged-n", dict(h=16, hkv=16, n=8000, nq=8000, d=64),
              (torch.bfloat16,)),
             ("suffix-nq", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=1000, d=64),
              (torch.bfloat16,)),
             ("small-blocks", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                                   d=64, bs=32, top_k=32),
              (torch.bfloat16, torch.float32)),
             ("block-512", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                                d=64, bs=512, top_k=2), (torch.bfloat16,)),
             ("block-512-d128", dict(h=16, hkv=8, n=4096, nq=4096, d=128,
                                     bs=512, top_k=2), (torch.bfloat16,)),
             ("top_k-16", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                               d=64, bs=64, top_k=16), (torch.bfloat16,)),
             ("top_k-64", dict(h=16, hkv=16, n=4096, nq=4096, d=64, bs=16,
                               top_k=64), (torch.bfloat16, torch.float32))]
    checks, timing, main_err, topk_more = [], None, {}, {}
    for name, geom, dtypes in geoms:
        for dtype in dtypes:
            c = _train_case(dtype=dtype, seed=11, **geom)
            rec = _check_train_kernels(c, dtype)
            torch.cuda.synchronize()
            checks.append({"geometry": name, "dtype": str(dtype), **rec})
            if not all(r["ok"] for r in rec.values()):
                emit({"phase": "train_kernels", "checks": checks})
                raise SystemExit(f"train_kernels: a kernel disagrees with "
                                 f"its plain version: {checks[-1]}")
            if name == "moba-340m" and dtype == torch.bfloat16:
                main_err = {k: r["max_abs_err"] for k, r in rec.items()}
                timing = _time_train_kernels(c, flush)
                timing["flash_moba"] = _time_flash_moba(c, flush)
            if name == "small-blocks" and dtype == torch.bfloat16:
                small_topk = _time_flash_topk(c, flush)
            if name.startswith("top_k-") and dtype == torch.bfloat16:
                topk_more[name] = _time_flash_topk(c, flush, full=False)
            if name == "moba-340m" and dtype == torch.float32:
                vs_xla = _flash_vs_xla(c)
                if not vs_xla["ok"]:
                    emit({"phase": "train_kernels", "checks": checks,
                          "flash_vs_xla": vs_xla})
                    raise SystemExit(f"train_kernels: flash_moba disagrees "
                                     f"with the xla path: {vs_xla}")
            del c
            torch.cuda.empty_cache()
    # Flash TopK alone at its limit, top_k 1024 (shared-memory lists, 16
    # rows a CTA): one head, so the plain routing's scores stay 0.27 GB
    c = _topk_case(h=1, hkv=1, n=32768, nq=32768, d=64,
                   dtype=torch.bfloat16, seed=11, bs=16, top_k=1024)
    rec = {"flash_topk": _check_flash_topk(c)}
    checks.append({"geometry": "top_k-1024", "dtype": str(c["q"].dtype),
                   **rec})
    if not rec["flash_topk"]["ok"]:
        emit({"phase": "train_kernels", "checks": checks})
        raise SystemExit(f"train_kernels: Flash TopK disagrees with the "
                         f"plain routing: {checks[-1]}")
    topk_more["top_k-1024"] = _time_flash_topk(c, flush, full=False, reps=5)
    del c
    torch.cuda.empty_cache()
    timing["flash_topk_small_blocks"] = small_topk
    timing["flash_topk_more"] = topk_more
    emit({"phase": "train_kernels", "tensor_core_audit": audit,
          "checks": checks, "flash_vs_xla": vs_xla, "timing": timing})
    return timing, main_err


# ------------------------------------------------------------------ phase 6
def _counts():
    from repro_torch.kernels import centroids, flash_topk, moba_bwd, moba_fwd
    return {"block_centroids": centroids.LAUNCHES,
            "flash_topk": flash_topk.LAUNCHES, "moba_fwd": moba_fwd.LAUNCHES,
            "moba_bwd": moba_bwd.LAUNCHES}


def _zero_counts():
    from repro_torch.kernels import centroids, flash_topk, moba_bwd, moba_fwd
    for mod in (centroids, flash_topk, moba_fwd, moba_bwd):
        mod.LAUNCHES = 0


def _train_run(backend: str, steps: int = TRAIN_STEPS, **moba):
    """moba-340m at full width and depth (bf16, random weights from a
    seeded torch.Generator), batch 1, seq 8192: ``steps`` steps of
    ``make_train_step`` with remat on ``backend``, from the same weights
    and batches on every call; ``moba`` (block_size, top_k,
    key_conv_width) overrides the config's MoBA settings.  Returns the
    state for one more step, each step's loss and seconds (each loss
    read waits for its step)."""
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    cfg = get_config("moba-340m", **moba)
    tcfg = TrainConfig(global_batch_size=1, seq_len=TRAIN_SEQ,
                       total_steps=TRAIN_STEPS + 1, warmup_steps=1)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw.adamw_init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=1, seed=0))
    batches = [{"tokens": torch.as_tensor(data.batch_at(i)["tokens"],
                                          device="cuda")}
               for i in range(TRAIN_STEPS + 1)]
    step_fn = S.make_train_step(cfg, tcfg, backend=backend, remat=True)
    torch.cuda.synchronize()
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[i])
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    return cfg, (step_fn, params, opt, batches[steps]), losses, step_s


def phase_train():
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    cfg, (step_fn, params, opt, batch), losses, step_s = _train_run("flash")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        wall = time.perf_counter() - t0
    del step_fn, params, opt, batch
    torch.cuda.empty_cache()
    # the same steps on xla (TRAIN_LOSS_TOL says why they may differ)
    _, _, xla_losses, xla_s = _train_run("xla")
    torch.cuda.empty_cache()
    loss_gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    steady = float(np.median(step_s[1:]))
    want = {"block_centroids": 2 * MOBA_LAYERS, "flash_topk": 2 * MOBA_LAYERS,
            "moba_fwd": 2 * MOBA_LAYERS, "moba_bwd": MOBA_LAYERS}
    rec = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
           "batch": 1, "seq": TRAIN_SEQ, "remat": True, "backend": "flash",
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_4": steady * 1e3,
           "tokens_per_s": TRAIN_SEQ / steady, "peak_mem_gib": peak,
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items()},
           "expected_per_step": want,
           "xla_losses": xla_losses, "xla_step_ms": [t * 1e3 for t in xla_s],
           "flash_vs_xla_max_loss_gap": loss_gap,
           "flash_vs_xla_loss_tol": TRAIN_LOSS_TOL,
           "profile": _profile_summary(prof, wall, 1)}
    emit(rec)
    if not all(np.isfinite(losses + xla_losses)):
        raise SystemExit(f"train: a loss is not finite: {losses} / "
                         f"{xla_losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * TRAIN_STEPS:
            raise SystemExit(f"train: {k} launched {launches[k]} times in "
                             f"{TRAIN_STEPS} steps, expected {per_step} "
                             f"per step")
    if loss_gap > TRAIN_LOSS_TOL:
        raise SystemExit(f"train: flash and xla losses differ by "
                         f"{loss_gap} > {TRAIN_LOSS_TOL}: {losses} / "
                         f"{xla_losses}")
    return launches, rec


def phase_train_small_blocks(steps: int = 3):
    """The paper's small-block setting on the same model: block 32, top_k
    32 (the same 1,024 keys a query as block 128, top_k 8), 3 steps on
    ``flash``: finite losses, exact launch counts, step ms, peak memory.
    The counts are zeroed just before this run and read just after."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    cfg, _, losses, step_s = _train_run("flash", steps, block_size=32,
                                        top_k=32)
    launches = _counts()
    want = {"block_centroids": 2 * MOBA_LAYERS, "flash_topk": 2 * MOBA_LAYERS,
            "moba_fwd": 2 * MOBA_LAYERS, "moba_bwd": MOBA_LAYERS}
    rec = {"phase": "train_small_blocks", "arch": cfg.name,
           "block_size": 32, "top_k": 32, "batch": 1, "seq": TRAIN_SEQ,
           "remat": True, "backend": "flash", "losses": losses,
           "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_3": float(np.median(step_s[1:])) * 1e3,
           "tokens_per_s": TRAIN_SEQ / float(np.median(step_s[1:])),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "expected_per_step": want}
    emit(rec)
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise SystemExit(f"train_small_blocks: a loss is not finite: "
                         f"{losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * steps:
            raise SystemExit(f"train_small_blocks: {k} launched "
                             f"{launches[k]} times in {steps} steps, "
                             f"expected {per_step} per step")
    return rec


def phase_train_key_conv(train_rec: dict, steps: int = 3):
    """moba-340m-kconv3 at full width and depth, phase 6's batches, 3
    steps on ``flash`` with remat (counts zeroed just before, read just
    after): finite losses, phase 6's launch counts, every MoBA layer's
    ``key_conv`` gradient finite and nonzero in every step, the conv
    weights moved; step ms, tokens/s and peak memory beside phase 6's.
    Then the same steps on ``xla``: each loss within TRAIN_LOSS_TOL."""
    import torch
    from repro_torch.optim import adamw
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    update, grads, start = adamw.adamw_update, [], {}

    def recording(params, g, state, tcfg, lr_fn=None):
        """The step's own update, keeping the conv leaves' gradients and
        (on the first step) weights."""
        if not start:
            start.update({p: x.detach().clone() for p, x in
                          adamw.tree_leaves(params) if p.endswith("key_conv")})
        grads.append({p: x.detach().clone() for p, x in adamw.tree_leaves(g)
                      if p.endswith("key_conv")})
        return update(params, g, state, tcfg, lr_fn)

    adamw.adamw_update = recording
    try:
        _zero_counts()
        cfg, (_, params, _, _), losses, step_s = _train_run(
            "flash", steps, key_conv_width=KEY_CONV_WIDTH)
        launches = _counts()
    finally:
        adamw.adamw_update = update
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    leaves = dict(adamw.tree_leaves(params))
    moved = {p: [float(x) for x in
                 (leaves[p].detach() - w).flatten(1).abs().amax(1)]
             for p, w in start.items()}
    grad_max = [{p: [float(x) for x in g.flatten(1).abs().amax(1)]
                 for p, g in step.items()} for step in grads]
    grads_ok = bool(grads) and all(
        torch.isfinite(g).all() and (g.flatten(1).abs().amax(1) > 0).all()
        for step in grads for g in step.values())
    del params, leaves, start, grads
    torch.cuda.empty_cache()
    _, _, xla_losses, xla_s = _train_run("xla", steps,
                                         key_conv_width=KEY_CONV_WIDTH)
    torch.cuda.empty_cache()
    loss_gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    steady = float(np.median(step_s[1:]))
    want = {"block_centroids": 2 * MOBA_LAYERS, "flash_topk": 2 * MOBA_LAYERS,
            "moba_fwd": 2 * MOBA_LAYERS, "moba_bwd": MOBA_LAYERS}
    rec = {"phase": "train_key_conv", "arch": cfg.name, "dtype": cfg.dtype,
           "batch": 1, "seq": TRAIN_SEQ, "remat": True, "backend": "flash",
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_3": steady * 1e3,
           "tokens_per_s": TRAIN_SEQ / steady, "peak_mem_gib": peak,
           "train_phase": {k: train_rec[k] for k in (
               "median_step_ms_steps_2_4", "tokens_per_s", "peak_mem_gib")},
           "launches": launches, "expected_per_step": want,
           "key_conv_grad_max_per_layer": grad_max,
           "key_conv_grads_finite_nonzero": grads_ok,
           "key_conv_moved_per_layer": moved,
           "xla_losses": xla_losses, "xla_step_ms": [t * 1e3 for t in xla_s],
           "flash_vs_xla_max_loss_gap": loss_gap,
           "flash_vs_xla_loss_tol": TRAIN_LOSS_TOL,
           "conv_alone": _time_key_conv()}
    emit(rec)
    if not all(np.isfinite(losses + xla_losses)):
        raise SystemExit(f"train_key_conv: a loss is not finite: {losses} / "
                         f"{xla_losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * steps:
            raise SystemExit(f"train_key_conv: {k} launched {launches[k]} "
                             f"times in {steps} steps, expected {per_step} "
                             f"per step")
    if not grads_ok or not moved or not all(
            min(v) > 0 for v in moved.values()):
        raise SystemExit("train_key_conv: a key_conv gradient is not finite "
                         "or is zero, or the conv weights did not move")
    if loss_gap > TRAIN_LOSS_TOL:
        raise SystemExit(f"train_key_conv: flash and xla losses differ by "
                         f"{loss_gap} > {TRAIN_LOSS_TOL}: {losses} / "
                         f"{xla_losses}")
    return launches


def _time_key_conv() -> dict:
    """The conv alone at its main-path shapes, as ``call_cost``s: one
    MoBA layer's training forward and backward (k 1 x 16 x 8192 x 64
    bf16, weights fp32; a step runs the forward twice under remat and
    the backward once) and one decode layer's conv and ring write (k 8 x
    16 x 1 x 64, the ring 8 x 16 x 2 x 64 bf16: ``apply_key_conv_decode``
    then the ``where``/``copy_`` of ``_paged_attend``)."""
    import torch
    from repro_torch.core import key_conv as KC
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = KC.init_key_conv(gen, KEY_CONV_WIDTH, 16, 64).requires_grad_()
    k = torch.randn((1, 16, TRAIN_SEQ, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    dk = torch.randn_like(k)
    ring = torch.randn((8, 16, KEY_CONV_WIDTH - 1, 64), generator=gen,
                       device="cuda", dtype=torch.bfloat16)
    k_new = torch.randn((8, 16, 1, 64), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    active = torch.ones(8, dtype=torch.bool, device="cuda")

    def forward():
        with torch.no_grad():
            KC.apply_key_conv(w, k)

    def forward_backward():
        torch.autograd.grad(KC.apply_key_conv(w, k), (k, w), dk)

    def decode():
        with torch.no_grad():
            _, stepped = KC.apply_key_conv_decode(w, k_new, ring)
            ring.copy_(torch.where(active[:, None, None, None], stepped,
                                   ring))

    return {"train_forward": call_cost(forward, flush),
            "train_forward_backward": call_cost(forward_backward, flush),
            "decode_layer": call_cost(decode, flush)}


# ------------------------------------------------------------------ phase 7
def phase_train_grads(block_size: int = 128, top_k: int = 8,
                      key_conv_width: int = 0):
    """flash against xla through the whole model in fp32.  The xla run
    replays the flash run's block selections layer by layer, so both
    sides compute the same function; each replayed selection is held to
    the plain routing of the xla run's own q and k by the near-tie rule
    (a near-tie could otherwise flip one query's blocks between the two
    runs, since their inputs differ in the last bits)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moba as CM
    from repro_torch.core import routing
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    seq = 2048
    cfg = dataclasses.replace(get_config(
        "moba-340m", block_size=block_size, top_k=top_k,
        key_conv_width=key_conv_width), dtype="float32")
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=1, seed=1)).batch_at(0)
    batch = {"tokens": torch.as_tensor(tokens["tokens"], device="cuda")}
    flash_topk, plain_selection = ops.flash_topk, CM.moba_selection
    recorded, audit = [], []

    def record(*args, **kw):
        sel = flash_topk(*args, **kw)
        recorded.append(sel)
        return sel

    def replay(q, k, moba_cfg, q_positions=None):
        b, h, nq, d = q.shape
        hkv, n = k.shape[1], k.shape[2]
        sel = recorded[len(audit)][:, :nq]
        mine = plain_selection(q, k, moba_cfg, q_positions)
        kv = ref.kv_rows(b * h, h, h // hkv, q.device)
        cents = routing.block_centroids(k, moba_cfg.block_size)
        masked = _masked_scores(q.reshape(b * h, nq, d),
                                cents.reshape(b * hkv, -1, d)[kv], n,
                                moba_cfg.block_size)
        audit.append(_near_ties(masked, sel, mine.reshape(b * h, nq, -1)))
        return sel.reshape(b, h, nq, -1)

    out = {}
    try:
        for backend in ("flash", "xla"):
            ops.flash_topk, CM.moba_selection = (
                (record, plain_selection) if backend == "flash"
                else (flash_topk, replay))
            leaves = [leaf.detach().requires_grad_() for _, leaf in
                      adamw.tree_leaves(params)]
            loss, _ = T.lm_loss(adamw.tree_like(params, leaves), batch, cfg,
                                backend=backend)
            out[backend] = (float(loss.detach()),
                            torch.autograd.grad(loss, leaves))
    finally:
        ops.flash_topk, CM.moba_selection = flash_topk, plain_selection
    names = [p for p, _ in adamw.tree_leaves(params)]
    rels = {n: _max_rel(a, b) for n, a, b in zip(names, out["flash"][1],
                                                 out["xla"][1])}
    worst = max(rels, key=rels.get)
    loss_rel = abs(out["flash"][0] - out["xla"][0]) / abs(out["xla"][0])
    routing_ok = len(audit) == MOBA_LAYERS and all(ok for _, _, ok in audit)
    ok = loss_rel <= 2e-4 and rels[worst] <= 5e-3 and routing_ok
    emit({"phase": "train_grads", "arch": cfg.name, "dtype": "float32",
          "seq": seq, "block_size": block_size, "top_k": top_k,
          "key_conv_width": key_conv_width,
          "loss_flash": out["flash"][0], "loss_xla": out["xla"][0],
          "loss_rel_err": loss_rel, "loss_tol": 2e-4,
          "worst_leaf": worst, "worst_leaf_rel_err": rels[worst],
          "key_conv_leaf_rel_err": {n: r for n, r in rels.items()
                                    if n.endswith("key_conv")},
          "grad_tol": 5e-3, "leaves": len(rels),
          "routing_rows_differing_per_layer": [r for r, _, _ in audit],
          "routing_max_gap": max((g for _, g, _ in audit), default=0.0),
          "routing_near_ties_ok": routing_ok, "ok": ok})
    if not ok:
        raise SystemExit("train_grads: flash and xla losses or gradients "
                         "disagree, or a routing difference is no near-tie")


# ------------------------------------------------------------------ phase 8
def _swa_inputs(*, b, h, hkv, n, d, dtype, seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * h, n, d), generator=gen, device="cuda") * 0.5
    k = torch.randn((b * hkv, n, d), generator=gen, device="cuda") * 0.5
    v = torch.randn((b * hkv, n, d), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _flex_yardstick(q4, k4, v4, w: int, scale: float, ref, flush) -> dict:
    """``torch.nn.attention.flex_attention`` with a sliding-window
    ``BlockMask`` (it skips the blocks outside the band), compiled once
    and then timed: one PyTorch call for the same function, a yardstick
    the port never calls.  If it cannot be built, the error instead."""
    import torch
    try:
        import torch._inductor.config as inductor_config
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        build = os.path.join(SRC, "repro_torch", "kernels", "build")
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                              os.path.join(build, "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(build, "triton"))
        inductor_config.compile_threads = 1      # no worker processes
        n = q4.shape[2]
        mask = create_block_mask(
            lambda b, h, qi, ki: (qi >= ki) & (qi - ki < w), B=None, H=None,
            Q_LEN=n, KV_LEN=n, device="cuda")
        flex = torch.compile(flex_attention, dynamic=False)
        t0 = time.perf_counter()
        out = flex(q4, k4, v4, block_mask=mask, scale=scale)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
    except Exception as e:          # a yardstick: record why, time none
        return {"flex_error": f"{type(e).__name__}: {e}"[:600]}
    return {"flex_ms": cuda_events_ms(
                lambda: flex(q4, k4, v4, block_mask=mask, scale=scale),
                flush=flush),
            "flex_compile_s": compile_s,
            "flex_max_abs_err": float((out[0].float() - ref.float())
                                      .abs().max())}


def _time_swa(KS, q, k, v, w: int, kw: dict, flush) -> dict:
    """At one shape: the kernel launch alone, the wrapper, the plain
    version and band SDPA as calls, flex in bf16, and the bound from
    these tensors."""
    import torch
    import torch.nn.functional as F
    n, d = q.shape[1], q.shape[2]
    scale = d ** -0.5
    pos = torch.arange(n, device="cuda")
    band = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < w)
    pairs = float(band.sum()) * q.shape[0]       # (query, key) pairs kept
    q4, k4, v4 = (x[None] for x in (q, k, v))    # (1, H, N, d)

    bf16 = q.dtype == torch.bfloat16
    rec = {"kernel_only_ms": cuda_events_ms(
               lambda: KS.launch(q, k, v, w, kw["num_q_heads"], kw["group"],
                                 scale, 128, 128), flush=flush),
           **call_cost(lambda: KS.swa_attention(q, k, v, w, **kw), flush),
           **call_cost(lambda: KS.swa_attention_plain(q, k, v, w, **kw),
                       flush, "plain_"),
           **call_cost(lambda: F.scaled_dot_product_attention(
               q4, k4, v4, attn_mask=band), flush, "library_"),
           **_bound(4 * q.numel() * q.element_size(), 4.0 * pairs * d,
                    BF16_FLOPS if bf16 else FP32_FLOPS)}
    if bf16:
        ref = KS.swa_attention_plain(q, k, v, w, **kw)
        rec.update(_flex_yardstick(q4, k4, v4, w, scale, ref, flush))
    return rec


def phase_swa():
    """``swa_attention``'s CUDA kernel against its plain version
    (``dense_attention`` with the window) in bf16 (the tensor-core body,
    3e-2) and fp32 (the SIMT body, 2e-4): moba-340m's SWA shapes (one
    sequence of 8192 tokens, 16 heads of 64, window 256) and the same at
    d 128, GQA (16 heads on 8 kv heads at d 128; 32 on 4 at d 128),
    window 100 with q_tile 128 / k_tile 64, a window at least N, window
    1, and N 96 (a ragged tile).  First the tensor-core audit of the
    library.  Then times at the moba-340m shapes, d 64 and d 128, bf16
    and fp32 (``_time_swa``).  No serving or training path calls it; its
    launches are this phase's checks."""
    import torch
    from repro_torch.kernels import swa as KS
    audit = _tensor_core_audit("swa", ("swa",))
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [("moba-340m", dict(b=1, h=16, hkv=16, n=TRAIN_SEQ, d=64),
              dict(window=256)),
             ("gqa-d128", dict(b=2, h=16, hkv=8, n=2048, d=128),
              dict(window=256)),
             ("window-100", dict(b=1, h=16, hkv=16, n=4096, d=64),
              dict(window=100, q_tile=128, k_tile=64)),
             ("window-ge-n", dict(b=2, h=4, hkv=4, n=1024, d=64),
              dict(window=1500)),
             ("n-96", dict(b=1, h=4, hkv=4, n=96, d=64), dict(window=40)),
             ("window-1", dict(b=1, h=16, hkv=16, n=2048, d=64),
              dict(window=1)),
             ("moba-340m-d128", dict(b=1, h=16, hkv=16, n=TRAIN_SEQ, d=128),
              dict(window=256)),
             ("gqa-g8", dict(b=2, h=32, hkv=4, n=4096, d=128),
              dict(window=256))]
    timed = ("moba-340m", "moba-340m-d128")
    tols = {bf16: 3e-2, fp32: 2e-4}
    checks, mains = [], {}
    KS.LAUNCHES = 0
    for name, shape, opts in cases:
        for dtype in (bf16, fp32):
            q, k, v = _swa_inputs(dtype=dtype, seed=5, **shape)
            kw = dict(num_q_heads=shape["h"],
                      group=shape["h"] // shape["hkv"])
            out = KS.swa_attention(q, k, v, **opts, **kw)
            ref = KS.swa_attention_plain(q, k, v, opts["window"], **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = tols[dtype]
            ok = bool(torch.allclose(out.float(), ref.float(), atol=tol,
                                     rtol=tol)) and out.dtype == dtype
            checks.append({"geometry": name, "dtype": str(dtype),
                           **opts, "max_abs_err": err, "tol": tol,
                           "ok": ok})
            if not ok:
                emit({"phase": "swa", "checks": checks})
                raise SystemExit(f"swa: the kernel disagrees with its plain "
                                 f"version: {checks[-1]}")
            if name in timed:
                mains[name, dtype] = (q, k, v, opts["window"], kw, err)
            del out, ref
            torch.cuda.empty_cache()
    launches = KS.LAUNCHES
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    timing = {}
    for (name, dtype), (q, k, v, w, kw, err) in mains.items():
        timing[f"{name}:{str(dtype).split('.')[-1]}"] = {
            **_time_swa(KS, q, k, v, w, kw, flush), "max_abs_err": err,
            "shape": [1, q.shape[0], q.shape[1], q.shape[2]], "window": w}
    emit({"phase": "swa", "replaces": "src/repro/kernels/swa.py:77",
          "tensor_core_audit": audit, "cta_rows": KS.CTA_ROWS,
          "key_chunk": KS.KEY_CHUNK, "checks": checks,
          "launches": launches, "timing": timing})
    return launches, timing


# ------------------------------------------------------------------- --ab
def _ab_decode() -> dict:
    """The decode call at the moba-340m phase-2 case with bf16 q and pool:
    ``call_cost`` of the call and of the library call, and the reading
    without the spin."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.core.moba import moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    cfg = MoBAConfig(block_size=128, top_k=8)
    q, pool, table, kv = _paged_case(
        b=8, h=16, hkv=16, d=64, ps=128, npg=33, num_pages=320,
        kv_lens=[0, 1, 128, 100, 1500, 3000, 4224, 2777],
        dtype=torch.bfloat16, seed=7)

    def call():
        return MD.moba_paged_decode(q, pool["pages_k"], pool["pages_v"],
                                    pool["centroids"], table, kv, cfg)

    idx, sel_valid = moba_paged_route(q, pool["centroids"], table, kv, cfg)
    library = decode_library(q, pool, table, kv, idx, sel_valid)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    out = call()
    torch.cuda.synchronize()
    return {"finite": bool(torch.isfinite(out).all()),
            **call_cost(call, flush),
            "ms_no_hold": cuda_events_ms(call, flush=flush, hold="none"),
            **call_cost(library, flush, "library_")}


def _ab_train_kernels() -> dict:
    """Device ms of the Flash TopK launch, ``moba_fwd.launch`` and
    ``moba_bwd.launch`` alone on the phase-5 moba-340m bf16 case, dO in
    the dtype the tree's backward wrapper takes."""
    import torch
    from repro_torch.kernels import flash_topk as KT
    from repro_torch.kernels import moba_bwd as KB, moba_fwd as KF, ref
    c = _train_case(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ, d=64,
                    dtype=torch.bfloat16, seed=11)
    lay, kw, tile = c["lay"], c["kw"], c["tile"]
    fkw = {k: v for k, v in kw.items() if k != "block_size"}
    args = (lay.tile_block, c["q_sorted"], c["q_pos"], c["k_blocks"],
            c["v_blocks"])
    _, m, l = ref.moba_partials_ref(*args, **kw)
    lse = m.clamp(min=-5e29) + torch.log(l.clamp(min=1e-30))
    do = torch.randn(c["q_sorted"].shape, generator=c["gen"],
                     device="cuda").to(_do_dtype(KB, c))
    delta = torch.randn(lse.shape, generator=c["gen"], device="cuda") * 0.1
    tables = KB.segments(lay.tile_block, c["nb"])
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    # Flash TopK through its wrapper, whose only device work is the launch
    # (the trees' ``launch`` signatures differ)
    return {"do_dtype": str(do.dtype),
            "flash_topk_ms": cuda_events_ms(
                lambda: KT.flash_topk(c["qf"], c["cents"], c["top_k"],
                                      c["bs"], group=c["g"],
                                      num_q_heads=c["h"], q_tile=tile),
                flush=flush),
            "moba_fwd_ms": cuda_events_ms(
                lambda: KF.launch(*args, q_tile=tile, kb_tile=128,
                                  causal=True, **fkw), flush=flush),
            "moba_bwd_ms": cuda_events_ms(
                lambda: KB.launch(tables, c["q_sorted"], c["q_pos"], do, lse,
                                  delta, c["k_blocks"], c["v_blocks"],
                                  q_tile=tile, causal=True, **fkw),
                flush=flush)}


def _ab_swa() -> dict:
    """Device ms of ``swa_attention`` through its public wrapper (whose
    API both trees share; its only device work is the launch and the
    output's allocation) at moba-340m's SWA shape: bf16 and fp32 at d 64,
    bf16 at d 128."""
    import torch
    from repro_torch.kernels import swa as KS
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rec = {}
    for key, d, dtype in (("swa_bf16_ms", 64, torch.bfloat16),
                          ("swa_fp32_ms", 64, torch.float32),
                          ("swa_d128_ms", 128, torch.bfloat16)):
        q, k, v = _swa_inputs(b=1, h=16, hkv=16, n=TRAIN_SEQ, d=d,
                              dtype=dtype, seed=5)
        rec[key] = cuda_events_ms(
            lambda: KS.swa_attention(q, k, v, 256, num_q_heads=16),
            flush=flush)
    return rec


def _ab_one() -> dict:
    """One tree's numbers for ``--ab`` (its ``src`` first on the path)."""
    import torch
    from repro_torch.kernels import moba_decode
    rec = {"module": moba_decode.__file__, **_ab_decode(),
           **_ab_train_kernels(), **_ab_swa()}
    torch.cuda.empty_cache()
    _, _, losses, step_s = _train_run("flash")
    rec.update(train_losses=losses,
               train_median_step_ms=float(np.median(step_s[1:])) * 1e3)
    rec["finite"] = rec["finite"] and bool(np.isfinite(losses).all())
    return rec


AB_KEYS = ("ms", "device_ms", "loop_us", "ms_no_hold", "library_ms",
           "library_device_ms", "library_loop_us", "flash_topk_ms",
           "moba_fwd_ms", "moba_bwd_ms", "swa_bf16_ms", "swa_fp32_ms",
           "swa_d128_ms", "train_median_step_ms")


def ab(other: str) -> int:
    """The decode call, the FlashMoBA forward and backward launches,
    ``swa_attention`` and the training step of the checkout at ``other``
    and of this one, each in a process of its own, in the order other,
    this, this, other, so a drift of the card shows.  One JSON line a
    process, then each tree's medians and the ratio other / this."""
    trees = {"other": os.path.abspath(other), "this": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ab-one", trees[which]],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        emit({"which": which, "tree": trees[which], **rec})
        if not rec["finite"]:
            return 1
        runs[which].append(rec)
    med = {w: {k: float(np.median([r[k] for r in rs])) for k in AB_KEYS}
           for w, rs in runs.items()}
    emit({"nvidia_smi": smi, "median": med,
          "other_over_this": {k: med["other"][k] / med["this"][k]
                              for k in AB_KEYS}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "on one NVIDIA card and check it.")
    ap.add_argument("--ab", metavar="DIR",
                    help="instead of the phases, time the decode call, the "
                         "FlashMoBA forward and backward, swa_attention and "
                         "the training step of the checkout at DIR and of "
                         "this one")
    ap.add_argument("--ab-one", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ab_one:
        sys.path.insert(0, os.path.join(args.ab_one, "src"))
        emit(_ab_one())
        return 0
    sys.path.insert(0, SRC)
    if args.ab:
        return ab(args.ab)
    t_start, seconds = time.perf_counter(), {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    smi = timed("env", phase_env)
    timing = timed("kernel", phase_kernel)
    launches, kernel_launches = {}, {}
    launches["fp32"], kernel_launches["fp32"], bf16_bytes, _ = timed(
        "serve", phase_serve)
    for kv_dtype in KV_DTYPES[1:]:
        launches[kv_dtype], kernel_launches[kv_dtype], _, _ = timed(
            "serve_quantized", phase_serve, kv_dtype, QUANT_NEW_TOKENS,
            bf16_bytes)
    # key conv and qwen3-0.6b: the decode calls of each path (counts
    # zeroed inside phase_serve just before its run, read just after)
    decode_also = {}
    for kv_dtype, key in (("fp32", "serve_key_conv"),
                          ("int8", "serve_key_conv_int8")):
        decode_also[key] = timed(
            "serve_key_conv", phase_serve, kv_dtype, QUANT_NEW_TOKENS,
            key_conv_width=KEY_CONV_WIDTH, prefill_chunk=1000,
            phase="serve_key_conv")[:2]
    for kv_dtype in KV_DTYPES:
        timed("logits", phase_logits, kv_dtype)
    timed("key_conv_logits", phase_key_conv_logits)
    decode_also["serve_qwen3"] = timed(
        "serve_qwen3", phase_serve, arch="qwen3-0.6b", prompts=4,
        new_tokens=16, phase="serve_qwen3")[:2]
    timed("serve_qwen3", phase_logits, arch="qwen3-0.6b",
          phase="serve_qwen3_logits")
    decode_also["serve_adaptive"] = timed("serve_adaptive",
                                          phase_serve_adaptive)[:2]
    train_timing, train_err = timed("train_kernels", phase_train_kernels)
    train_launches, train_rec = timed("train", phase_train)
    small_blocks = timed("train_small_blocks", phase_train_small_blocks)
    train_also = {"train_small_blocks": small_blocks["launches"],
                  "train_key_conv": timed("train_key_conv",
                                          phase_train_key_conv, train_rec)}
    timed("train_grads", phase_train_grads)
    timed("train_grads", phase_train_grads, block_size=32, top_k=32)
    timed("train_key_conv", phase_train_grads,
          key_conv_width=KEY_CONV_WIDTH)
    swa_launches, swa_timing = timed("swa", phase_swa)
    emit({"phase_seconds": seconds,
          "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    kernels = []
    for kv_dtype in KV_DTYPES:
        t = timing[kv_dtype]
        budgets = ({"with_budgets": {
            k: {f: v[f] for f in ("ms", "device_ms", "loop_us",
                                  "kernel_only_ms", "mean_n_uniq",
                                  "bytes", "bound_ms", "bound_by")}
            for k, v in timing["budgets"].items()}}
            if kv_dtype == "fp32" else {})
        kernels.append({
            "name": "moba_paged_decode" + ("" if kv_dtype == "fp32"
                                           else f":{kv_dtype}"),
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "pool": "bf16" if kv_dtype == "fp32" else kv_dtype,
            "launches": launches[kv_dtype],
            "launches_are": "decode calls, each launching the route, "
                            "attention and merge kernels",
            "kernel_launches": kernel_launches[kv_dtype],
            **({"launches_also": {
                k: {"calls": c, "kernel_launches": n}
                for k, (c, n) in decode_also.items()
                if (k == "serve_key_conv_int8") == (kv_dtype == "int8")}}
               if kv_dtype in ("fp32", "int8") else {}),
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "loop_us": t["loop_us"], "kernel_only_ms": t["kernel_only_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"], **budgets,
            "checked": True})
    for name, (_, source, replaces) in TRAIN_KERNELS.items():
        t = train_timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "launches_also": {k: v[name] for k, v in train_also.items()},
            "max_abs_err": train_err[name], "ms": t["ms"],
            "device_ms": t["device_ms"], "kernel_only_ms": t["kernel_only_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **({"sdpa_yardstick_ms": t["sdpa_yardstick_ms"]}
               if "sdpa_yardstick_ms" in t else {}),
            **({"topk_yardstick_ms": t["topk_yardstick_ms"],
                "small_blocks": {
                    k: train_timing["flash_topk_small_blocks"][k]
                    for k in ("ms", "kernel_only_ms", "plain_ms",
                              "bound_ms", "bound_by", "topk_yardstick_ms",
                              "shape")},
                "alone_at": {
                    g: {k: r[k] for k in ("kernel_only_ms", "bound_ms",
                                          "bound_by", "shape")}
                    for g, r in train_timing["flash_topk_more"].items()}}
               if name == "flash_topk" else {}),
            "checked": True})
    name, source, replaces = SWA_KERNEL
    t = swa_timing["moba-340m:bfloat16"]
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": swa_launches,
        "launches_from": "the swa phase's checks: no serving or training "
                         "path launches it",
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "device_ms": t["device_ms"], "kernel_only_ms": t["kernel_only_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        **{k: t[k] for k in ("flex_ms", "flex_error") if k in t},
        "also_at": {g: {k: r[k] for k in (
            "kernel_only_ms", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "shape", "flex_ms", "flex_error")
            if k in r}
            for g, r in swa_timing.items() if g != "moba-340m:bfloat16"},
        "checked": True})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
