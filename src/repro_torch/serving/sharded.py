"""Sharded serving engine: the single-device :class:`~repro_torch.serving.
engine.Engine` scaled over S shards without changing any attention math.

  * every shard is one :class:`~repro_torch.serving.engine.Engine` on its
    own device, with its own page pool (pages, scales, centroid cache,
    key-conv rings), scheduler and host swap store;
  * a host-side :class:`Router` assigns each incoming request to one
    shard, after which its whole lifetime (admission, growth,
    preemption, swap, replay) is handled by that shard's engine;
  * each fleet step plans and prefills on every shard, then dispatches
    every shard's decode before it observes any of them, so the shards'
    steps overlap; nothing crosses shards and a request's greedy tokens
    equal the single-device engine's;
  * a request longer than one shard's pool cannot be paged: it falls
    back to context-parallel prefill and decode over the same devices
    (the ``sp`` backend, ``distributed/moba_sp.py``), its MoBA K/V and
    centroid caches held as one sequence segment per shard.

One host process drives every shard, as the reference's single
controller drives its ``shard_map`` over the mesh ``data`` axis.  Shards
are devices given as a list, which may repeat one: several shards on one
card (or on the CPU) run the same logic and launches, but show neither
transfers between cards nor any speed-up from more of them.  A shard
pads its prefill rows to its own bucket: the reference's one global
bucket is what its SPMD step needs, and eager shards need no such thing.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantization as Q
from repro_torch.device import resolve_device
from repro_torch.distributed import moba_sp
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.serving.engine import (Engine, EngineConfig, Prefix,
                                        admission_capability_check,
                                        build_route_profile,
                                        parse_engine_route_policy,
                                        resolve_engine_backend,
                                        resolve_pool_sizes,
                                        unsupported_reason)
from repro_torch.serving.scheduler import (Request, Scheduler, ServingError,
                                           UnsupportedFeatureError)


class Router:
    """Host-side router over per-shard schedulers.

    ``pick`` prefers the shard whose prefix tree holds the longest cached
    prefix of the request (``peek_prefix``, which touches no LRU clock:
    each shard's tree is private, so affinity is what turns shared
    system prompts into page sharing), then the smallest page demand
    ``load`` (committed + queued pages), then the lowest shard id — fully
    deterministic for a given submission order.  Without the prefix
    cache every peek is 0 and this is least-loaded routing.  Returns −1
    when no shard can ever serve the request (the engine's
    context-parallel fallback or refusal)."""

    def __init__(self, scheds: Sequence[Scheduler]):
        self.scheds = scheds

    def pick(self, req: Request) -> int:
        fitting = [s for s, sch in enumerate(self.scheds) if sch.fits(req)]
        if not fitting:
            return -1
        return min(fitting, key=lambda s: (-self.scheds[s].peek_prefix(req),
                                           self.scheds[s].load, s))


def resolve_shard_devices(n_shards: int, devices=None) -> List[torch.device]:
    """The shards' devices: ``devices`` as given (one per shard, repeats
    allowed, each resolved by ``device.resolve_device``), or with None
    shard i on ``cuda:i``, which needs as many visible cards as shards."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_shards > visible:
            raise ServingError(
                f"n_shards={n_shards} exceeds the {visible} visible "
                f"devices; pass devices= to place several shards on one "
                f"device, e.g. devices=['cuda:0'] * {n_shards}")
        devices = [f"cuda:{i}" for i in range(n_shards)]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ServingError("a sharded engine needs at least one shard")
    return out


def _tree_to(tree, dev: torch.device):
    """A nested dict of tensors on ``dev`` (tensors already there are
    shared, not copied)."""
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


class ShardedEngine:
    """Continuous-batching engine with one page pool per shard.  ``ecfg``
    sizes are PER SHARD (``max_seqs`` slots and ``num_pages`` pages on
    every shard); total capacity is ``n_shards`` times that.  API mirrors
    :class:`~repro_torch.serving.engine.Engine`: ``submit`` / ``step`` /
    ``run`` / ``drain`` / ``stats`` (+ ``shard_stats``), and ``prefill`` /
    ``insert`` / ``generate_step`` for the staged front ends.

    ``devices`` is the counterpart of the reference's ``mesh=``: a list of
    the shards' devices (``n_shards`` is then its length), or None for
    shard i on ``cuda:i``.  Params go to each distinct device once."""

    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None, n_shards: int = 2,
                 devices=None):
        reason = unsupported_reason(cfg)
        if reason is not None:
            raise UnsupportedFeatureError(*reason)
        self.cfg = cfg
        self.ecfg = ecfg = ecfg or EngineConfig()
        self.attn_backend = resolve_engine_backend(ecfg.attn_backend,
                                                   "sharded")
        self.devices = resolve_shard_devices(n_shards, devices)
        self.n_shards = len(self.devices)
        if ecfg.kv_dtype not in Q.KV_DTYPES:
            raise ServingError(
                f"unknown kv_dtype {ecfg.kv_dtype!r}; expected one of "
                f"{Q.KV_DTYPES}")
        route_mode, _ = parse_engine_route_policy(ecfg.route_policy)
        # the single-device admission query, additionally demanding
        # per-shard math that needs no other shard (Capabilities.sharded)
        admission_capability_check(cfg, self.attn_backend, sharded=True,
                                   kv_dtype=ecfg.kv_dtype,
                                   adaptive=route_mode != "static")
        self.page_size, self.pages_per_seq, self.num_pages = \
            resolve_pool_sizes(cfg, ecfg)
        on_dev = {}
        for dev in self.devices:
            if dev not in on_dev:
                on_dev[dev] = _tree_to(params, dev)
        self.params = on_dev[self.devices[0]]
        # ONE routing profile, calibrated (or loaded) once on the lead
        # device; every shard routes from it, so a request's tokens cannot
        # depend on the shard the router picked.  The context-parallel
        # fallback stays on static routing, as in the reference.
        self.route_profile, _ = build_route_profile(
            cfg, self.params, ecfg.route_policy, self.pages_per_seq)
        shard_ecfg = dataclasses.replace(ecfg, attn_backend=self.attn_backend)
        self.engines = [Engine(cfg, on_dev[dev], shard_ecfg, device=dev,
                               route_profile=self.route_profile)
                        for dev in self.devices]
        self.finished: List[Request] = []
        for eng in self.engines:
            eng.finished = self.finished        # one list, in finish order
        self.router = Router(self.scheds)
        self._next_rid = 0
        self._t0 = None
        self._requests = [0] * self.n_shards
        self.stats = {"decode_steps": 0, "pages_in_use_peak": 0,
                      "cp_requests": 0, "cp_tokens": 0, "cp_s": 0.0}
        self._update_stats()
        # context-parallel fallback, built at its first use; ``cp_record``
        # splits its seconds and the bytes its group moved between shards
        # (by kind) into prefill and decode
        self._cp_queue: Deque[Request] = collections.deque()
        self._cp_group: Optional[moba_sp.CPGroup] = None
        self._cp_prefill = None
        self._cp_decode = None
        self.cp_record = {"prefill_s": 0.0, "decode_s": 0.0,
                          "decode_steps": 0,
                          "prefill_bytes": collections.Counter(),
                          "decode_bytes": collections.Counter()}

    @property
    def scheds(self) -> List[Scheduler]:
        return [e.sched for e in self.engines]

    @property
    def caches(self) -> List[Dict]:
        """Each shard's paged cache tree, on its device."""
        return [e.caches for e in self.engines]

    @property
    def shard_stats(self) -> List[Dict]:
        """Per shard: requests routed there, prefill and decode tokens,
        and the fleet steps it ran a decode in (a shard with no running
        request sits a step out)."""
        return [{"prefill_tokens": e.stats["prefill_tokens"],
                 "decode_tokens": e.stats["decode_tokens"],
                 "decode_steps": e.stats["decode_steps"], "requests": n}
                for e, n in zip(self.engines, self._requests)]

    def _update_stats(self) -> None:
        """Fleet counters from the shards': sums, the deepest pipeline,
        and the peak of the pages in use over all shards together.
        ``decode_steps`` counts fleet steps and the ``cp_*`` keys the
        fallback; both are kept here."""
        st = self.stats
        for key in self.engines[0].stats:
            if key not in ("decode_steps", "pages_in_use_peak",
                           "dispatch_depth_peak"):
                st[key] = sum(e.stats[key] for e in self.engines)
        st["dispatch_depth_peak"] = max(e.stats["dispatch_depth_peak"]
                                        for e in self.engines)
        st["pages_in_use_peak"] = max(
            st["pages_in_use_peak"],
            sum(e.num_pages - e.sched.alloc.available for e in self.engines))

    def _wall(self) -> float:
        return (0.0 if self._t0 is None
                else time.perf_counter() - self._t0)

    def _start_clock(self) -> None:
        """One clock base for the fleet and every shard's timestamps."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
            for e in self.engines:
                e._t0 = self._t0

    # ------------------------------------------------------------- intake
    def make_request(self, prompt: Sequence[int], max_new_tokens: int,
                     arrival: float = 0.0, eos_id: Optional[int] = None
                     ) -> Request:
        """Build a request WITHOUT queueing it — the staged intake.
        Routing happens at :meth:`prefill`; requests that only the
        context-parallel fallback can serve go through :meth:`submit` and
        the legacy loop instead."""
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, arrival=arrival,
                      eos_id=eos_id)
        self._next_rid += 1
        return req

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival: float = 0.0, eos_id: Optional[int] = None
               ) -> Request:
        req = self.make_request(prompt, max_new_tokens, arrival, eos_id)
        shard = self.router.pick(req)
        if shard < 0:
            need = len(req.prompt) + max_new_tokens
            if need > self.cp_capacity:
                raise ServingError(
                    f"request {req.rid}: prompt+gen {need} tokens exceed "
                    f"even the context-parallel capacity "
                    f"{self.cp_capacity} ({self.n_shards} shards)")
            self._cp_queue.append(req)       # longer than one shard's pool
            return req
        req.shard = shard
        self.engines[shard].sched.submit(req)
        self._requests[shard] += 1
        return req

    # --------------------------------------------------------------- sizes
    @property
    def shard_capacity(self) -> int:
        """Tokens one shard's pool can hold."""
        return self.num_pages * self.page_size

    @property
    def cp_capacity(self) -> int:
        """Longest context the context-parallel fallback serves: the
        fleet's pool size, dense-cached over all shards."""
        return self.n_shards * self.shard_capacity

    def drain(self) -> None:
        """Observe every shard's in-flight decode steps."""
        for e in self.engines:
            e.drain()
        self._update_stats()

    # ------------------------------------------------------------- stages
    def prefill(self, req: Request, now: float = float("inf")
                ) -> Optional[Prefix]:
        """Stage 1 over shards: route ``req`` (a preemption replay keeps
        its shard, whose swap store and prefix tree hold its state) and
        prefill it on that shard's engine.  Returns None when the shard
        cannot host it right now.  Raises for a request only the
        context-parallel fallback can serve: that decode is synchronous
        and solo, so it is not staged; :meth:`submit` and :meth:`run`
        serve it."""
        self._start_clock()
        fresh = req.shard < 0
        shard = self.router.pick(req) if fresh else req.shard
        if shard < 0:
            raise ServingError(
                f"request {req.rid}: no shard can page "
                f"{len(req.prompt)} + {req.max_new_tokens} tokens; the "
                f"context-parallel fallback is not staged — submit() + "
                f"run() serve it synchronously")
        prefix = self.engines[shard].prefill(req, now)
        if prefix is not None and fresh:
            req.shard = shard
            self._requests[shard] += 1
        self._update_stats()
        return prefix

    def insert(self, prefix: Prefix, slot: Optional[int] = None) -> bool:
        """Stage 2: bind a prefilled request into its shard's decode
        batch.  False when the handle went stale (preempted since
        prefill) — re-prefill it."""
        return self.engines[prefix.req.shard].insert(prefix, slot)

    def generate_step(self, now: float = float("inf")
                      ) -> List[Tuple[Request, int]]:
        """Stage 3: every shard's growth/preemption plan, then one decode
        dispatch on every shard with decoding requests, then each shard's
        observation: the ``(request, token)`` pairs observed this call
        (one pipeline-depth behind dispatch when ``dispatch_ahead > 0``)."""
        decodes = [e._plan_decode(now) for e in self.engines]
        for e, reqs in zip(self.engines, decodes):
            if reqs:
                e._dispatch_decode(reqs)
        self.stats["decode_steps"] += any(decodes)
        out = []
        for e, reqs in zip(self.engines, decodes):
            out += e._settle(bool(reqs))
        self._update_stats()
        return out

    @property
    def preempted_waiting(self) -> List[Request]:
        """Preemption victims awaiting re-prefill, across all shards."""
        return [r for e in self.engines for r in e.preempted_waiting]

    # ------------------------------------------------- legacy closed loop
    def step(self, now: float = float("inf")) -> Dict:
        """One fleet iteration of the legacy closed loop: at most one arrived
        context-parallel request (served solo and synchronously), then on
        every shard its plans, prefill and decode dispatch, then every
        shard's decode observed synchronously."""
        self.drain()
        n_cp = 0
        if self._cp_queue and self._cp_queue[0].arrival <= now:
            self._run_cp(self._cp_queue.popleft())
            n_cp = 1
        parts = [e._step_dispatch(now) for e in self.engines]
        self.stats["decode_steps"] += any(d for _, _, d in parts)
        n_done = sum(e._step_observe() for e in self.engines)
        self._update_stats()
        return {"prefilled": sum(len(p) for _, p, _ in parts),
                "decoded": sum(len(d) for _, _, d in parts),
                "finished": n_done + n_cp, "cp_served": n_cp,
                "preempted": sum(n for n, _, _ in parts)}

    # ------------------------------------------- context-parallel fallback
    def _cp_setup(self) -> moba_sp.CPGroup:
        """Build the context-parallel group over the shards' devices and
        the dense-cache step pair on the ``sp`` backend, once."""
        if self._cp_group is None:
            self._cp_group = moba_sp.CPGroup(self.devices)
            self._cp_prefill = S.make_prefill_step(self.cfg, backend="sp")
            self._cp_decode = S.make_decode_step(self.cfg, backend="sp")
        return self._cp_group

    def _run_cp(self, req: Request) -> None:
        """Serve one over-long request with context parallelism: its MoBA
        layers' K/V and centroid caches are held as one sequence segment
        per shard, on the shard's device; routing runs on shard-local
        centroids and only the query, the candidates and the (o, m, l)
        partials cross between shards (``distributed/moba_sp.py``).  The
        other layers' dense caches stay on the lead device."""
        cfg = self.cfg
        group = self._cp_setup()
        # a multiple of shards × block so every segment holds whole blocks
        bs = cfg.attention.moba.block_size if cfg.attention.moba else 1
        unit = self.n_shards * math.lcm(self.page_size, bs)
        need = len(req.prompt) + req.max_new_tokens
        max_len = -(-need // unit) * unit
        lead = self.devices[0]
        caches = T.init_caches(cfg, 1, max_len,
                               dtype=getattr(torch, cfg.dtype), device=lead,
                               segments=self.devices)
        rec = self.cp_record
        bytes0 = dict(group.bytes)
        t0 = time.perf_counter()
        with moba_sp.use_group(group):
            logits, caches = self._cp_prefill(
                self.params, torch.as_tensor(req.prompt[None], device=lead),
                caches)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
            req.cache_len = len(req.prompt)
            req.out.append(int(tok[0, 0]))
            req.t_first = self._wall()
            t1 = time.perf_counter()
            bytes1 = dict(group.bytes)
            while not req.done:
                tok, caches = self._cp_decode(self.params, tok, caches)
                req.out.append(int(tok[0, 0]))
                req.cache_len += 1
                rec["decode_steps"] += 1
        t2 = time.perf_counter()
        for k, n in group.bytes.items():
            rec["prefill_bytes"][k] += bytes1.get(k, 0) - bytes0.get(k, 0)
            rec["decode_bytes"][k] += n - bytes1.get(k, 0)
        for c in (rec["prefill_bytes"], rec["decode_bytes"]):
            c += collections.Counter()      # drops the kinds at zero
        rec["prefill_s"] += t1 - t0
        rec["decode_s"] += t2 - t1
        # CP wall time is kept apart from the paged counters so per-shard
        # tokens/s (decode_tokens / decode_s) stays honest
        self.stats["cp_s"] += t2 - t0
        self.stats["cp_requests"] += 1
        self.stats["cp_tokens"] += len(req.out)
        req.state = "done"
        req.t_done = self._wall()
        self.finished.append(req)

    # ---------------------------------------------------------------- run
    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines) \
            or bool(self._cp_queue)

    def run(self, realtime: bool = False) -> List[Request]:
        """Drain all submitted requests (paged shards and the
        context-parallel fallback, in arrival order within each path) and
        return the ones finished by this call."""
        n0 = len(self.finished)
        self._start_clock()
        while self.has_work():
            now = self._wall() if realtime else float("inf")
            self.step(now=now)
            if realtime and not any(sch.running for sch in self.scheds):
                pending = [sch.waiting[0].arrival for sch in self.scheds
                           if sch.waiting]
                pending += [r.arrival for r in list(self._cp_queue)[:1]]
                if pending:
                    wait = min(pending) - self._wall()
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
        return self.finished[n0:]
