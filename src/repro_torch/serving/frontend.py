"""Front ends over the staged engine API.

Two drivers on top of ``prefill`` / ``insert`` / ``generate_step``:

  * :func:`run_open_loop` — a deterministic open-loop trace driver:
    requests arrive on a fixed schedule measured in DECODE STEPS
    (machine-independent, unlike wall-clock Poisson arrivals) whether or
    not the engine keeps up — the load model behind sustained tokens/s
    and p99 time-to-first-token figures.
  * :class:`AsyncFrontend` — a stdlib-``asyncio`` streaming front end:
    callers ``submit`` and consume per-request token streams while one
    pump task drives the stages; device work runs in the event loop's
    default executor so the loop stays responsive.  ``launch/serve.py
    --http`` wraps it in an HTTP server.

Both drivers handle preemption replay explicitly (victims surface on
``engine.preempted_waiting`` and are re-prefilled before new arrivals).
The engine's step functions carry their own ``torch.no_grad()`` and
every kernel wrapper selects its card and reads the current stream at
launch, so nothing thread-local has to be set on the executor's threads.
"""
from __future__ import annotations

import asyncio
import collections
import time
from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.scheduler import Request


@dataclass(frozen=True)
class TraceItem:
    """One open-loop arrival: ``prompt`` lands ``arrival_step`` decode
    steps into the run, ready or not (that is what makes the trace open
    loop — the schedule never waits for the engine)."""
    prompt: Sequence[int]
    max_new_tokens: int
    arrival_step: int = 0
    eos_id: Optional[int] = None


def run_open_loop(engine, trace: Sequence[TraceItem],
                  max_stalls: int = 3) -> List[Request]:
    """Drive ``engine`` through ``trace`` with the staged API and return
    the requests in trace order.

    Each iteration re-prefills preemption victims first (they hold
    replay priority), then admits every due arrival, then takes one
    :meth:`generate_step` — so admission happens at decode cadence, and
    a full pool simply defers arrivals to a later step (their ``arrival``
    timestamp is stamped when due, so TTFT charges the queueing delay).
    Raises ``RuntimeError`` if the engine stalls with arrivals that can
    never be admitted.
    """
    pending = collections.deque(
        sorted(enumerate(trace), key=lambda p: (p[1].arrival_step, p[0])))
    reqs: List[Optional[Request]] = [None] * len(trace)
    step = 0
    stalls = 0
    while pending or engine.has_work():
        for r in list(engine.preempted_waiting):
            p = engine.prefill(r)
            if p is None:
                break
            engine.insert(p)
        admitted = False
        while pending and pending[0][1].arrival_step <= step:
            i, item = pending[0]
            if reqs[i] is None:
                reqs[i] = engine.make_request(
                    item.prompt, item.max_new_tokens, eos_id=item.eos_id)
                reqs[i].arrival = engine._wall()   # due now: TTFT clock
            p = engine.prefill(reqs[i])            # starts, queued or not
            if p is None:
                break                              # pool full: next step
            engine.insert(p)
            pending.popleft()
            admitted = True
        emitted = engine.generate_step()
        step += 1
        if emitted or admitted or engine.has_work():
            stalls = 0
        elif pending:
            step = max(step, pending[0][1].arrival_step)   # idle gap
            stalls += 1
            if stalls > max_stalls:
                raise RuntimeError(
                    f"open-loop driver stalled: {len(pending)} arrivals "
                    f"cannot be admitted on an idle engine")
    return [r for r in reqs if r is not None]


def open_loop_metrics(reqs: Sequence[Request], wall_s: float,
                      stats: Dict) -> Dict:
    """Latency/throughput accounting for a finished open-loop run:
    sustained tokens/s over the whole wall, TTFT (arrival → first
    token, queueing included) and TPOT (steady-state inter-token time)
    percentiles, plus the pipeline-depth evidence that dispatch-ahead
    actually engaged."""
    ttft = np.array([r.t_first - r.arrival for r in reqs]) \
        if reqs else np.zeros(1)
    tpot = np.array([(r.t_done - r.t_first) / (len(r.out) - 1)
                     for r in reqs if len(r.out) > 1])
    if tpot.size == 0:
        tpot = np.zeros(1)
    total = sum(len(r.out) for r in reqs)
    return {
        "requests": len(reqs),
        "wall_s": wall_s,
        "generated_tokens": total,
        "sustained_tokens_per_s": total / max(wall_s, 1e-9),
        "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
        "ttft_p99_ms": float(np.percentile(ttft, 99) * 1e3),
        "tpot_p50_ms": float(np.percentile(tpot, 50) * 1e3),
        "tpot_p99_ms": float(np.percentile(tpot, 99) * 1e3),
        "dispatch_depth_peak": stats["dispatch_depth_peak"],
        "pipeline_drains": stats["pipeline_drains"],
        "preemptions": stats["preemptions"],
        "decode_steps": stats["decode_steps"],
    }


class AsyncFrontend:
    """Async streaming front end over one staged engine.

    One pump task owns the engine; callers interact through
    :meth:`submit` (returns the request) and :meth:`stream` (async
    iterator of its tokens, closing when generation finishes).  Device
    work — prefill chunks and decode steps — runs in the event loop's
    default executor, so awaiting callers are only ever blocked by their
    own tokens' availability, not by the host thread.

    Usage::

        fe = AsyncFrontend(engine)
        await fe.start()
        req = fe.submit(prompt, max_new_tokens=32)
        async for tok in fe.stream(req):
            ...
        await fe.close()
    """

    def __init__(self, engine):
        self.engine = engine
        self._queues: Dict[int, asyncio.Queue] = {}
        self._pending: collections.deque = collections.deque()
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._fin_cursor = len(engine.finished)
        self._closed = False

    async def start(self) -> None:
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._pump())

    async def close(self) -> None:
        """Stop the pump after in-flight requests finish; pending
        streams get their sentinel either way."""
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
        if self._closed:
            raise RuntimeError("frontend closed")
        req = self.engine.make_request(prompt, max_new_tokens,
                                       eos_id=eos_id)
        req.arrival = self.engine._wall()
        self._queues[req.rid] = asyncio.Queue()
        self._pending.append(req)
        if self._wake is not None:
            self._wake.set()
        return req

    async def stream(self, req: Request) -> AsyncIterator[int]:
        q = self._queues.get(req.rid)
        if q is None:
            raise KeyError(f"request {req.rid} unknown or already "
                           f"consumed")
        while True:
            tok = await q.get()
            if tok is None:
                # consumer owns cleanup: the pump only enqueues the
                # sentinel, so a stream opened after the request
                # finished still drains its tokens
                self._queues.pop(req.rid, None)
                return
            yield tok

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        eng = self.engine

        def _emit(rid: int, tok: Optional[int]) -> None:
            q = self._queues.get(rid)
            if q is not None:
                q.put_nowait(tok)

        while True:
            if not self._pending and not eng.has_work():
                if self._closed:
                    break
                self._wake.clear()
                await self._wake.wait()
                continue
            for r in list(eng.preempted_waiting):    # replay priority
                p = await loop.run_in_executor(None, eng.prefill, r)
                if p is None:
                    break
                eng.insert(p)
                _emit(r.rid, p.token)    # replays resample a NEW token
            while self._pending:
                req = self._pending[0]
                p = await loop.run_in_executor(None, eng.prefill, req)
                if p is None:
                    break                # pool full: retry next tick
                eng.insert(p)
                self._pending.popleft()
                _emit(req.rid, p.token)  # first token comes from prefill
            emitted = await loop.run_in_executor(None, eng.generate_step)
            for r, tok in emitted:
                _emit(r.rid, tok)
            for r in eng.finished[self._fin_cursor:]:
                _emit(r.rid, None)       # close the stream
            self._fin_cursor = len(eng.finished)
            await asyncio.sleep(0)       # let consumers drain
        for rid in list(self._queues):   # closed with work undone
            _emit(rid, None)


def time_open_loop(engine, trace: Sequence[TraceItem]) -> Dict:
    """Convenience wrapper: run the trace, return its metrics dict plus
    the finished requests under ``"_requests"`` (callers that only want
    JSON can ``pop`` it)."""
    t0 = time.perf_counter()
    reqs = run_open_loop(engine, trace)
    wall = time.perf_counter() - t0
    m = open_loop_metrics(reqs, wall, engine.stats)
    m["_requests"] = reqs
    return m
