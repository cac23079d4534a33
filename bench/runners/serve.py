"""The serving runner: ``repro_torch.serving.engine.Engine`` fed by the
traffic's request stream through its own loop (``submit`` and ``step``:
admit up to ``max_prefill_batch`` prompts into one ragged prefill, then
one decode step over every running sequence, observed before it
returns), greedy, with no end-of-sequence token.

Set-up makes the weights, builds the engine, serves one request at each
power-of-two prompt length the traffic reaches (the prefill's shapes),
and fills every client before the window opens.  In the window, each
client sends its next request when its last one ends.  After the window
nothing new is sent, and every request sent in it is followed to its end
(at most ``drain_s`` past the close; one that has not ended by then
counts as failed).  Times are the host's clock at the end of the engine
step in which a request's tokens became visible.

``correct``: after the engine is freed, the reference runs once over a
sample of the finished requests, drawn from the seed with the longest
among them, and the widest gap by which a served token's logit lies
below the reference's best is compared.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import arith, checks, faults, reference, trace, traffic, weights
from bench.runners import program


class _Req:
    __slots__ = ("req", "sent", "first", "done", "seen", "in_window")

    def __init__(self, req, sent: float, in_window: bool):
        self.req, self.sent, self.in_window = req, sent, in_window
        self.first = self.done = None
        self.seen = 0


def _decode_spans(kv_lens: List[torch.Tensor]):
    """Install a ``bench.moba_decode`` span around the program's paged
    MoBA decode call, keeping each call's post-append lengths; returns
    the undo."""
    from repro_torch.kernels import moba_decode

    call = moba_decode.moba_paged_decode

    def spanned(*a, **k):
        kv = a[5] if len(a) > 5 else k["kv_len"]
        kv_lens.append(kv.detach().clone())
        with trace.span("moba_decode"):
            return call(*a, **k)

    moba_decode.moba_paged_decode = spanned

    def undo():
        moba_decode.moba_paged_decode = call
    return undo


def _warm_lengths(tr: dict) -> List[int]:
    """The traffic's prompt lengths at each power of two it spans, and its
    longest."""
    lo, hi = tr["prompt"]["min"], tr["prompt"]["max"]
    out, p = [], 1 << max(0, (lo - 1).bit_length())
    while p < hi:
        out.append(p)
        p *= 2
    return out + [hi]


def run(r) -> dict:
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg, tr, dev = r.config, r.traffic, r.device
    params = weights.make_params(cfg, r.seed, dev)
    page = cfg["moba"]["block_size"]
    max_len = -(-traffic.max_len(tr) // page) * page
    eng = Engine(program.model_config(cfg), params,
                 EngineConfig(max_seq_len=max_len, **tr["engine"]),
                 device=dev)
    stream = traffic.RequestStream(tr, cfg["vocab_size"], r.seed)
    warm_rng = np.random.default_rng([r.seed, 2])
    for n in _warm_lengths(tr):
        eng.submit(warm_rng.integers(0, cfg["vocab_size"], n,
                                     dtype=np.int32), max_new_tokens=2)
        while eng.has_work():
            eng.step()
    eng.finished.clear()

    live: Dict[int, _Req] = {}
    done: List[_Req] = []

    def send(now: float, in_window: bool):
        prompt, out = stream.next()
        req = eng.submit(prompt, max_new_tokens=out)
        live[req.rid] = _Req(req, now, in_window)

    def observe(now: float, count: bool) -> Tuple[int, int]:
        """Fold a finished engine step into the records: (tokens that
        became visible, counted if ``count``; requests that ended)."""
        new_tokens, ended = 0, 0
        for rid in list(live):
            q = live[rid]
            n = len(q.req.out)
            if n > q.seen:
                if q.first is None:
                    q.first = now
                new_tokens += n - q.seen
                q.seen = n
            if q.req.state == "done":
                q.done = now
                done.append(live.pop(rid))
                ended += 1
        return (new_tokens if count else 0), ended

    with faults.serving(eng, r.fault, cfg["vocab_size"]):
        # every client in flight before the window opens
        for _ in range(tr["arrivals"]["clients"]):
            send(time.perf_counter(), False)
        while any(q.first is None for q in live.values()):
            eng.step()
            _, ended = observe(time.perf_counter(), False)
            for _ in range(ended):
                send(time.perf_counter(), False)
        rec = {"setup_s": time.perf_counter() - r.t_start}
        peak_setup = (torch.cuda.max_memory_allocated(dev)
                      if dev.type == "cuda" else 0)

        st0 = st_w = dict(eng.stats)
        t0 = time.perf_counter()
        deadline = t0 + r.seconds
        tokens, t_last, kv_lens = 0, t0, []
        prof, prof_stats = None, None
        prof_at = t0 + tr["profile_after_s"]
        while True:
            now = time.perf_counter()
            if r.trace and prof is None and now >= prof_at:
                undo = _decode_spans(kv_lens)
                s0 = eng.stats["decode_steps"]
                with trace.profiled() as prof:
                    with trace.span("window"):
                        p_end = time.perf_counter() + tr["profile_s"]
                        while time.perf_counter() < p_end:
                            eng.step()
                            n, ended = observe(time.perf_counter(), True)
                            tokens += n
                            for _ in range(ended):
                                send(time.perf_counter(), True)
                undo()
                prof_stats = eng.stats["decode_steps"] - s0
                t_last, st_w = time.perf_counter(), dict(eng.stats)
                continue
            if not eng.has_work():   # the window has closed and drained
                break
            eng.step()
            now = time.perf_counter()
            n, ended = observe(now, now <= deadline)
            if now <= deadline:
                tokens += n
                t_last = now
                st_w = dict(eng.stats)
            if now < deadline:
                for _ in range(ended):
                    send(now, True)
            if now >= deadline and (
                    not any(q.in_window for q in live.values())
                    or now > deadline + tr["drain_s"]):
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rec["memory_peak_bytes"] = max(peak_setup,
                                       torch.cuda.max_memory_allocated(dev))

    sent = [q for q in done + list(live.values()) if q.in_window]
    failed = [q for q in sent if q.done is None]
    rec.update(
        window_s=t_last - t0, tokens=tokens, attempted=len(sent),
        failed=len(failed),
        trace=trace.reduce(prof),
        ttft_s=[math.inf if q.first is None else q.first - q.sent
                for q in sent],
        tpot_s=[math.inf if q.done is None else
                (q.done - q.first) / (q.seen - 1)
                for q in sent if q.done is None or q.seen > 1],
        stats={k: st_w[k] - st0[k] for k in st_w
               if isinstance(st_w[k], (int, float))},
        profiled_decode_steps=prof_stats)
    if kv_lens:
        rec["decode_least_s"] = sum(
            arith.moba_decode_work(cfg, kv.tolist(), eng.page_size)[2]
            for kv in kv_lens)

    # free the engine, then the reference over a sample of what it served
    sample = _sample([q.req for q in done], r.seed, tr["check_tokens"])
    del eng, params, live
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_params = weights.make_params(cfg, r.seed, dev)
    gaps = reference.served_gaps(ref_params, cfg, sample, dev,
                                  chunk=tr["ref_chunk"])
    rec["reference_s"] = time.perf_counter() - t
    rec["numbers"] = checks.serve_numbers(gaps)
    rec["sample"] = sample
    return rec


def _sample(reqs, seed: int, tokens: int):
    """(prompt, served tokens) of the longest finished request and of
    others drawn from the seed, until ``tokens`` served tokens."""
    if not reqs:
        raise RuntimeError("no request finished: nothing to check")
    longest = max(reqs, key=lambda q: len(q.prompt) + len(q.out))
    order = np.random.default_rng([seed, 3]).permutation(len(reqs))
    picked, n = [longest], len(longest.out)
    for i in order:
        if n >= tokens:
            break
        if reqs[i] is not longest:
            picked.append(reqs[i])
            n += len(reqs[i].out)
    return [(np.asarray(q.prompt), list(q.out)) for q in picked]
