"""Continuous-batching serving engine over the paged KV cache.

The engine owns the device state (params + paged caches) and two step
functions; the scheduler owns the host state (free pages, block table,
request queues).  The public surface is STAGED, as in the reference:

  * :meth:`Engine.prefill` — admit one request, cache its whole context
    (all chunks, applying any swap restore admission scheduled) and
    sample its first token; returns a :class:`Prefix` handle, or None
    when the pool cannot host it right now.
  * :meth:`Engine.insert` — bind a prefilled request into the decode
    batch at its slot.
  * :meth:`Engine.generate_step` — plan growth/preemption, dispatch one
    decode step over every bound slot, and return newly observed
    ``(request, token)`` pairs.  With ``dispatch_ahead > 0`` the host
    enqueues up to that many decode steps before blocking on the oldest
    one's tokens; the token vector chains on the device and the only
    host-device sync of a decode step is in :meth:`Engine._observe_one`.

The legacy closed loop — :meth:`step` / :meth:`run` — drives the stages
synchronously, so both drive patterns produce bit-identical greedy
streams.

The reference jits the steps and donates the caches; here the steps run
eagerly and write the pools in place.  Host arrays reach the card
through pinned buffers with ``non_blocking`` copies, so uploading a
step's tables does not wait for the steps already enqueued.

Supported: attention-only dense-family layer patterns, key convolution
(per-slot raw-key rings), whole-prompt and chunked prefill, preemption
by recompute and by host swap, dispatch-ahead, unquantized and int8/fp8
pools, and static or SNR-guided adaptive routing (``route_policy``: a
per-(layer, head) top_k profile calibrated or loaded once at
construction, :func:`build_route_profile`).  The reference's prefix
cache and sharded engine raise :class:`UnsupportedFeatureError` at
construction until their slices land (ROADMAP.md).
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
from repro_torch.core import adaptive as AD
from repro_torch.core import backends as B
from repro_torch.core import quantization as Q
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.scheduler import (Request, Scheduler, ServingError,
                                           UnsupportedFeatureError)

_LATER = "not ported yet; ROADMAP.md lists it among the remaining engine " \
         "features"


def prefill_bucket(n: int, page_size: int) -> int:
    """Power-of-two token bucket for ragged prefill rows."""
    b = max(16, page_size)
    while b < n:
        b *= 2
    return b


def resolve_engine_backend(spec: str, default: str) -> str:
    """``core.backends.resolve_backend_spec`` with admission-style
    errors: an unknown name or bad option string fails engine
    construction as a structured :class:`UnsupportedFeatureError`."""
    try:
        return B.resolve_backend_spec(spec, default=default)
    except B.BackendCapabilityError as e:
        raise UnsupportedFeatureError("attn_backend", str(e)) from e


def needs_key_conv(cfg: ModelConfig) -> bool:
    """Whether serving ``cfg`` exercises the key-conv rings."""
    a = cfg.attention
    return bool(a.moba is not None and a.moba.key_conv_width
                and any(k == "moba" for k in cfg.layer_pattern))


def admission_capability_check(cfg: ModelConfig, backend: str,
                               kv_dtype: str = "fp32",
                               adaptive: bool = False) -> None:
    """Every layer kind must resolve for both paged phases (with
    key-conv where the config carries it, quantized-pool support when
    ``kv_dtype`` is int8/fp8, per-head ``head_top_k`` routing on MoBA
    layers when ``adaptive``), or the request stream would die inside a
    step."""
    conv = needs_key_conv(cfg)
    for kind in sorted(set(cfg.layer_pattern)):
        for phase in ("prefill", "decode"):
            try:
                B.resolve(backend, kind=kind, phase=phase, cache="paged",
                          key_conv=conv and kind == "moba",
                          kv_dtype=kv_dtype,
                          adaptive=adaptive and kind == "moba")
            except B.BackendCapabilityError as e:
                raise UnsupportedFeatureError("attn_backend",
                                              str(e)) from e


def parse_engine_route_policy(policy: str) -> Tuple[str, Optional[object]]:
    """``core.adaptive.parse_route_policy`` with admission-style errors:
    a malformed policy fails engine construction as
    ``UnsupportedFeatureError("route_policy")``."""
    try:
        return AD.parse_route_policy(policy)
    except ValueError as e:
        raise UnsupportedFeatureError("route_policy", str(e)) from e


def build_route_profile(cfg: ModelConfig, params, route_policy: str,
                        pages_per_seq: int):
    """Resolve ``EngineConfig.route_policy`` into ``(profile,
    route_map)``: ``(None, None)`` for static routing.

    ``snr:pfail=P`` runs the calibration pass (``core/adaptive.py``) on
    the params' device against this engine's routing universe
    (``pages_per_seq``); ``profile:PATH`` loads a saved artifact.  Either
    is validated against the model's layer pattern, static ``top_k`` and
    block size.  Every budget lies in [1, top_k]: ``choose_top_k`` clips
    to it and ``RoutingProfile.load`` checks it against the file's
    ``k_max``, which must equal the model's ``top_k``.  That is the one
    place the decode kernel's budgets are checked by value."""
    mode, arg = parse_engine_route_policy(route_policy)
    if mode == "static":
        return None, None
    a = cfg.attention
    if a.moba is None or not any(k == "moba" for k in cfg.layer_pattern):
        raise UnsupportedFeatureError(
            "route_policy",
            f"adaptive routing needs a moba slot in the layer pattern; "
            f"got {cfg.layer_pattern}")
    if mode == "snr":
        profile = AD.calibrate_profile(cfg, params, arg,
                                       num_blocks=pages_per_seq)
    else:
        try:
            profile = AD.RoutingProfile.load(arg)
        except (OSError, ValueError, KeyError) as e:
            raise UnsupportedFeatureError(
                "route_policy", f"cannot load routing profile {arg!r}: "
                f"{e}") from e
    pattern = cfg.layer_pattern
    n_groups = cfg.num_layers // len(pattern)
    if profile.k_max != a.moba.top_k \
            or profile.block_size != a.moba.block_size:
        raise UnsupportedFeatureError(
            "route_policy",
            f"routing profile was calibrated for top_k={profile.k_max} "
            f"block_size={profile.block_size}, model has "
            f"top_k={a.moba.top_k} block_size={a.moba.block_size}")
    for slot, arr in profile.top_k.items():
        i = int(slot.rsplit("_", 1)[1])
        if i >= len(pattern) or pattern[i] != "moba" \
                or arr.shape != (n_groups, cfg.num_heads):
            raise UnsupportedFeatureError(
                "route_policy",
                f"routing profile slot {slot!r} (shape {arr.shape}) does "
                f"not match layer pattern {pattern} x {n_groups} groups "
                f"x {cfg.num_heads} heads")
    return profile, profile.route_map()


def resolve_pool_sizes(cfg: ModelConfig, ecfg: "EngineConfig"
                       ) -> Tuple[int, int, int]:
    """(page_size, pages_per_seq, num_pages) for one pool."""
    page_size = ecfg.page_size or PC.resolve_page_size(cfg)
    pages_per_seq = math.ceil(ecfg.max_seq_len / page_size)
    num_pages = ecfg.num_pages or ecfg.max_seqs * pages_per_seq
    return page_size, pages_per_seq, num_pages


def prefill_takes(reqs: List[Request], chunk: int) -> List[int]:
    """Tokens each request contributes this step: the whole remaining
    context, or at most ``chunk`` of it under chunked prefill."""
    return [min(chunk, left) if chunk else left
            for left in (len(r.context) - r.cache_len for r in reqs)]


def build_prefill_batch(sched, reqs: List[Request], takes: List[int],
                        bp: int, pages_per_seq: int, lmax: int):
    """Host-side arrays for one ragged prefill batch.  Rows past
    ``len(reqs)`` are padding: q_len 0, slot −1, table −1, inactive."""
    tokens = np.zeros((bp, lmax), np.int32)
    kv_len = np.zeros((bp,), np.int32)
    q_len = np.zeros((bp,), np.int32)
    slots = np.full((bp,), -1, np.int32)
    active = np.zeros((bp,), bool)
    table = np.full((bp, pages_per_seq), -1, np.int32)
    for i, (r, take) in enumerate(zip(reqs, takes)):
        ctx = r.context
        tokens[i, :take] = ctx[r.cache_len:r.cache_len + take]
        kv_len[i] = r.cache_len
        q_len[i] = take
        slots[i] = r.slot
        active[i] = True
        table[i] = sched.block_table[r.slot]
    return tokens, kv_len, q_len, slots, active, table


def build_decode_batch(reqs: List[Request], max_seqs: int):
    """Per-slot (kv_len, active) arrays for one decode step.  ``kv_len``
    counts dispatched-ahead steps still in flight: they already wrote
    the positions past ``cache_len``."""
    kv_len = np.zeros((max_seqs,), np.int32)
    active = np.zeros((max_seqs,), bool)
    for r in reqs:
        kv_len[r.slot] = r.cache_len + r.dispatched
        active[r.slot] = True
    return kv_len, active


def record_prefill(reqs: List[Request], takes: List[int], tok: np.ndarray,
                   cur_tok: np.ndarray, wall: float) -> None:
    """Post-prefill request bookkeeping: advance chunk offsets; rows
    whose context completed this step record the sampled token and join
    decoding."""
    for i, (r, take) in enumerate(zip(reqs, takes)):
        r.cache_len += take
        if r.cache_len < len(r.context):
            continue                     # more chunks to come
        r.state = "running"              # final chunk: join decoding
        r.out.append(int(tok[i]))
        cur_tok[r.slot] = tok[i]
        if r.t_first is None:
            r.t_first = wall


class HostSwapStore:
    """Host-memory backing store for preempted sequences.

    ``save`` snapshots a victim's written pages (K/V, centroids, scales)
    plus its key-conv ring row into ``req.swap_data`` *before* the
    scheduler frees them; total residency is capped at
    ``capacity_bytes`` — an over-cap save returns False and the
    scheduler falls back to recompute preemption.  On re-admission
    :func:`drain_cache_ops` scatters the snapshot into the newly reserved
    pages and the request's new slot, restores ``cache_len``, and frees
    the store bytes."""

    def __init__(self, engine, capacity_bytes: int):
        self._engine = engine
        self.capacity = capacity_bytes
        self.used = 0

    def save(self, req: Request, pages: List[int], slot: int) -> bool:
        data = PC.gather_pages_host(self._engine.caches, pages)
        ring = PC.gather_ring_rows(self._engine.caches, slot)
        nbytes = sum(v.nbytes for v in (*data.values(), *ring.values()))
        if self.used + nbytes > self.capacity:
            return False
        self.drop(req)
        req.swap_data = {"pages": data, "ring": ring,
                         "n_tokens": req.cache_len, "nbytes": nbytes}
        self.used += nbytes
        return True

    def drop(self, req: Request) -> None:
        if req.swap_data is not None:
            self.used -= req.swap_data["nbytes"]
            req.swap_data = None


def drain_cache_ops(caches, sched: Scheduler, swap_store, page_size: int):
    """Apply the scheduler's planned device cache ops: swap restores,
    which write a victim's pages into its newly reserved pages and its
    key-conv ring row into its new slot (the port's scheduler plans no
    COW copies or ring loads from page tails: both come only from the
    prefix cache, not ported yet).
    Restores also set the request's ``cache_len`` so the takes computed
    at prefill see the restored prefix."""
    ops = sched.take_cache_ops()
    if ops["copies"] or ops["ring_loads"]:
        raise ServingError("page copies / ring loads planned without the "
                           "prefix cache")
    for req in ops["restores"]:
        sd = req.swap_data
        pages = sched._seq_pages[req.slot][
            :math.ceil(sd["n_tokens"] / page_size)]
        caches = PC.scatter_pages_device(caches, pages, sd["pages"])
        if sd["ring"]:
            caches = PC.scatter_ring_rows(caches, req.slot, sd["ring"])
        req.cache_len = sd["n_tokens"]
        swap_store.drop(req)
        sched.stats["swap_restores"] += 1
    return caches


def unsupported_reason(cfg: ModelConfig) -> Optional[Tuple[str, str]]:
    """(feature, reason) the paged engine cannot serve, or None."""
    bad = [k for k in cfg.layer_pattern if k not in T.ATTN_KINDS]
    if bad:
        return ("layer_pattern",
                f"slots {bad} are not ported yet (the port serves "
                f"{T.ATTN_KINDS} layers)")
    if cfg.family != "dense":
        return ("family", f"family {cfg.family!r} is {_LATER}")
    return None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seqs: int = 8                  # concurrent sequence slots
    max_seq_len: int = 512             # per-sequence prompt+gen capacity
    num_pages: int = 0                 # 0 → max_seqs * pages_per_seq
    page_size: int = 0                 # 0 → MoBA block size (or 16)
    max_prefill_batch: int = 4
    prefill_chunk: int = 0             # split prompts into chunks of this
    #                                    many tokens across engine steps
    #                                    (0 = whole-prompt prefill)
    prefix_cache: bool = False         # radix-tree prefix cache (not
    #                                    ported yet: True raises)
    swap_bytes: int = 64 << 20         # host-memory cap for swap-based
    #                                    preemption; 0 = always recompute
    #                                    preempted prefixes
    kv_dtype: str = "fp32"             # paged-pool K/V storage: "fp32"
    #                                    (compute dtype, no scales), or
    #                                    "int8" / "fp8" payloads with
    #                                    per-(page, kv head) fp32 scales
    route_policy: str = "static"       # MoBA routing policy: "static"
    #                                    (uniform top_k), "snr:pfail=P"
    #                                    (calibrated per-head budgets) or
    #                                    "profile:PATH" (a saved profile);
    #                                    core/adaptive.py
    attn_backend: str = ""             # registered backend (core.backends);
    #                                    "" → "reference".  A
    #                                    "name:option" spec (e.g.
    #                                    "flash:flat") configures the
    #                                    registry instance PROCESS-WIDE
    dispatch_ahead: int = 1            # decode steps the host may enqueue
    #                                    before blocking on the oldest
    #                                    one's tokens (0 = synchronous).
    #                                    The legacy step()/run() driver
    #                                    drains every iteration regardless.


def out_of_scope(ecfg: EngineConfig) -> Optional[Tuple[str, str]]:
    """(field, reason) for an EngineConfig value the port cannot serve
    yet, or None."""
    if ecfg.prefix_cache:
        return ("prefix_cache", f"the radix-tree prefix cache (COW page "
                                f"copies, tree publishing) is {_LATER}")
    return None


@dataclasses.dataclass
class Prefix:
    """Handle returned by :meth:`Engine.prefill`: the request's whole
    context is cached in the paged pool at ``slot`` and its first token
    is sampled.  Pass to :meth:`Engine.insert` to join the decode batch.
    The handle goes stale if the request is preempted before insertion
    (``insert`` then returns False and the caller re-prefills)."""
    req: Request
    token: int
    slot: int


class Engine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig = None,
                 device="cuda"):
        reason = unsupported_reason(cfg)
        if reason is not None:
            raise UnsupportedFeatureError(*reason)
        self.ecfg = ecfg = ecfg or EngineConfig()
        if ecfg.kv_dtype not in Q.KV_DTYPES:
            raise ServingError(
                f"unknown kv_dtype {ecfg.kv_dtype!r}; "
                f"expected one of {Q.KV_DTYPES}")
        reason = out_of_scope(ecfg)
        if reason is not None:
            raise UnsupportedFeatureError(*reason)
        if ecfg.dispatch_ahead < 0:
            raise ServingError(
                f"dispatch_ahead must be >= 0, got {ecfg.dispatch_ahead}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.attn_backend = resolve_engine_backend(ecfg.attn_backend,
                                                   "reference")
        route_mode, _ = parse_engine_route_policy(ecfg.route_policy)
        admission_capability_check(cfg, self.attn_backend,
                                   kv_dtype=ecfg.kv_dtype,
                                   adaptive=route_mode != "static")
        self.page_size, self.pages_per_seq, self.num_pages = \
            resolve_pool_sizes(cfg, ecfg)
        # adaptive routing: calibrate (or load) the per-(layer, head)
        # top_k profile once; its budgets go to the card once, as int32
        # tensors every prefill and decode step (replays included) reads
        self.route_profile, route_map = build_route_profile(
            cfg, params, ecfg.route_policy, self.pages_per_seq)
        route_map = S.as_route_map(route_map, self.device)
        self.caches = T.init_paged_caches(
            cfg, self.num_pages, self.page_size,
            dtype=getattr(torch, cfg.dtype), device=self.device,
            kv_dtype=ecfg.kv_dtype, max_seqs=ecfg.max_seqs)
        self.swap_store = (HostSwapStore(self, ecfg.swap_bytes)
                           if ecfg.swap_bytes > 0 else None)
        self.sched = Scheduler(
            num_pages=self.num_pages, page_size=self.page_size,
            max_seqs=ecfg.max_seqs, max_pages_per_seq=self.pages_per_seq,
            max_prefill_batch=ecfg.max_prefill_batch,
            chunk_tokens=ecfg.prefill_chunk, key_conv=needs_key_conv(cfg),
            swap=self.swap_store)
        # swap restores resume mid-context, so their suffix prefills need
        # the chunk-aware (kv_len-offset) path even when chunked prefill
        # itself is off
        self._chunk_aware = bool(ecfg.prefill_chunk or ecfg.swap_bytes > 0)
        self._prefill = S.make_paged_prefill_step(
            cfg, backend=self.attn_backend, chunked=self._chunk_aware,
            route_map=route_map)
        self._decode = S.make_paged_decode_step(
            cfg, backend=self.attn_backend, route_map=route_map)
        self._cur_tok = np.zeros((ecfg.max_seqs,), np.int32)
        self._next_rid = 0
        self._t0 = None
        self.finished: List[Request] = []
        # dispatch-ahead pipeline: (batch membership, device tokens) per
        # dispatched-but-unobserved decode step, oldest first.  _tok_dev
        # is the device-resident current-token vector the chain feeds on
        # (None = rebuild from the host copy, which is only safe when
        # the pipeline is empty).
        self._inflight: Deque[Tuple[List[Request], torch.Tensor]] = \
            collections.deque()
        self._tok_dev = None
        self._emitted: List[Tuple[Request, int]] = []
        self.sched.before_preempt = self._sync_for_preempt
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_tokens": 0, "decode_steps": 0,
                      "decode_tokens": 0, "preemptions": 0,
                      "tree_evictions": 0, "pages_in_use_peak": 0,
                      "dispatch_depth_peak": 0, "pipeline_drains": 0}
        self.stats.update(self.sched.stats)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → device tensor without waiting on queued work."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # ------------------------------------------------------------- intake
    def make_request(self, prompt: Sequence[int], max_new_tokens: int,
                     arrival: float = 0.0, eos_id: Optional[int] = None
                     ) -> Request:
        """Build (and validate, but do NOT queue) a request — the staged
        intake."""
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, arrival=arrival,
                      eos_id=eos_id)
        self._next_rid += 1
        self.sched.validate(req)
        return req

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival: float = 0.0, eos_id: Optional[int] = None
               ) -> Request:
        req = self.make_request(prompt, max_new_tokens, arrival=arrival,
                                eos_id=eos_id)
        self.sched.submit(req)
        return req

    # -------------------------------------------------------------- steps
    def _run_prefill(self, reqs: List[Request], now: float) -> None:
        """One ragged prefill batch: each row is a request's whole context
        (one-shot mode) or its next ``prefill_chunk`` tokens (chunked
        mode, with ``kv_len`` carrying the chunk offset)."""
        takes = prefill_takes(reqs, self.ecfg.prefill_chunk)
        lmax = prefill_bucket(max(takes), self.page_size)
        arrays = build_prefill_batch(
            self.sched, reqs, takes, self.ecfg.max_prefill_batch,
            self.pages_per_seq, lmax)
        tokens, kv_len, q_len, slots, active, table = (
            self._to_device(a) for a in arrays)
        t0 = time.perf_counter()
        tok, self.caches = self._prefill(self.params, tokens, self.caches,
                                         table, kv_len, q_len, slots,
                                         active)
        tok = tok.cpu().numpy()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += int(sum(takes))
        record_prefill(reqs, takes, tok, self._cur_tok, self._wall())

    def _wall(self) -> float:
        return (0.0 if self._t0 is None
                else time.perf_counter() - self._t0)

    # ------------------------------------------- dispatch-ahead pipeline
    def _dispatch_decode(self, reqs: List[Request]) -> None:
        """Enqueue one decode step over ``reqs`` WITHOUT blocking on its
        tokens.  The current-token vector chains on the device
        (``torch.where`` keeps inactive slots)."""
        kv_len, active = build_decode_batch(reqs, self.ecfg.max_seqs)
        if self._tok_dev is None:       # pipeline empty: host copy is
            self._tok_dev = self._to_device(self._cur_tok)   # authoritative
        active_dev = self._to_device(active)
        t0 = time.perf_counter()
        tok, self.caches = self._decode(
            self.params, self._tok_dev, self.caches,
            self._to_device(self.sched.block_table),
            self._to_device(kv_len), active_dev)
        self._tok_dev = torch.where(active_dev, tok, self._tok_dev)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        for r in reqs:
            r.dispatched += 1
        self._inflight.append((list(reqs), tok))
        self.stats["dispatch_depth_peak"] = max(
            self.stats["dispatch_depth_peak"], len(self._inflight))

    def _observe_one(self) -> None:
        """Block on the OLDEST in-flight decode step and fold its tokens
        into host state.  Requests that hit EOS at an earlier
        observation skip recording: their overrun steps are discarded."""
        reqs, tok_dev = self._inflight.popleft()
        t0 = time.perf_counter()
        tok = tok_dev.cpu().numpy()     # the only host-device sync point
        self.stats["decode_s"] += time.perf_counter() - t0
        for r in reqs:
            r.dispatched -= 1
            if r.state != "running" or r.done:
                continue
            r.cache_len += 1
            t = int(tok[r.slot])
            r.out.append(t)
            self._cur_tok[r.slot] = t
            self.stats["decode_tokens"] += 1
            if r.t_first is None:
                r.t_first = self._wall()
            self._emitted.append((r, t))
        if not self._inflight:
            # pipeline empty → the host vector is authoritative again
            self._tok_dev = None

    def drain(self) -> None:
        """Observe every in-flight decode step.  Afterwards host
        bookkeeping (``cache_len``, ``out``, ``_cur_tok``) is consistent
        with device state."""
        if self._inflight:
            self.stats["pipeline_drains"] += 1
        while self._inflight:
            self._observe_one()

    def _sync_for_preempt(self) -> None:
        """``Scheduler.before_preempt`` hook: drain the pipeline and
        retire finished requests (freeing their pages) so preemption
        decisions see host-consistent state — and may become moot."""
        self.drain()
        self._finish_done()

    def _finish_done(self) -> None:
        for r in [r for r in self.sched.running
                  if r.state == "running" and r.done
                  and r.dispatched == 0]:
            self.sched.finish(r)
            r.t_done = self._wall()
            self.finished.append(r)

    def _update_stats(self) -> None:
        self.stats.update(self.sched.stats)
        self.stats["pages_in_use_peak"] = max(
            self.stats["pages_in_use_peak"],
            self.num_pages - self.sched.alloc.available)

    # ------------------------------------------------------------- stages
    def prefill(self, req: Request, now: float = float("inf")
                ) -> Optional[Prefix]:
        """Stage 1: admit ``req``, cache its whole context (all chunks
        under chunked prefill, with admission's swap restore applied
        first) and sample its first token.  Returns None when the pool or
        slots cannot host it right now."""
        if req.state not in ("waiting",) or req.slot >= 0:
            raise ServingError(
                f"request {req.rid}: prefill() on state {req.state!r} "
                f"(slot {req.slot}); only waiting requests stage")
        if self._t0 is None:
            self._t0 = time.perf_counter()
        queued = req in self.sched.waiting      # preemption replay
        if queued:
            self.sched.waiting.remove(req)
        ok = self.sched.admit(req)
        if not ok:
            # finished-but-unobserved requests may be holding the pages
            self._sync_for_preempt()
            ok = self.sched.admit(req)
        if not ok:
            if queued:      # keep the victim's replay priority
                self.sched.waiting.appendleft(req)
            return None
        # snapshot: the final chunk appends the sampled token to ``out``,
        # growing ``context`` by one
        target = len(req.context)
        while req.cache_len < target:
            self.caches = drain_cache_ops(self.caches, self.sched,
                                          self.swap_store, self.page_size)
            self._run_prefill([req], now)
        req.state = "prefilled"
        self._update_stats()
        return Prefix(req=req, token=int(req.out[-1]), slot=req.slot)

    def insert(self, prefix: Prefix, slot: Optional[int] = None) -> bool:
        """Stage 2: bind a prefilled request into the decode batch.
        Returns False when the handle went stale.  ``slot`` must match
        the slot admission bound at prefill: pages were written there."""
        req = prefix.req
        if slot is not None and slot != req.slot:
            raise ServingError(
                f"request {req.rid}: insert at slot {slot} but its pages "
                f"live at slot {req.slot}; slots bind at prefill")
        if req.state != "prefilled":
            return False
        req.state = "running"
        tok = int(req.out[-1])
        self._cur_tok[req.slot] = tok
        if self._tok_dev is not None:   # patch mid-pipeline: in-flight
            # steps never reference this slot, and stream order puts the
            # write after every step already enqueued
            self._tok_dev[req.slot] = tok
        return True

    def generate_step(self, now: float = float("inf")
                      ) -> List[Tuple[Request, int]]:
        """Stage 3: plan growth/preemption over the bound slots,
        dispatch one decode step, and return the ``(request, token)``
        pairs observed this call (one pipeline-depth late with
        ``dispatch_ahead > 0``)."""
        preempted = self.sched.plan_decode(now)
        self.stats["preemptions"] += len(preempted)
        self.caches = drain_cache_ops(self.caches, self.sched,
                                      self.swap_store, self.page_size)
        decodes = [r for r in self.sched.running
                   if r.state == "running" and not r.budget_spent]
        if decodes:
            self._dispatch_decode(decodes)
        depth = self.ecfg.dispatch_ahead if decodes else 0
        while len(self._inflight) > depth:
            self._observe_one()
        self._finish_done()
        self._update_stats()
        out, self._emitted = self._emitted, []
        return out

    def has_work(self) -> bool:
        """Queued, running, or in-flight work remains."""
        return self.sched.has_work() or bool(self._inflight)

    @property
    def preempted_waiting(self) -> List[Request]:
        """Preemption victims awaiting re-prefill, in replay order."""
        return [r for r in self.sched.waiting if r.n_preempt > 0]

    # ------------------------------------------------- legacy closed loop
    def step(self, now: float = float("inf")) -> Dict:
        """One legacy engine iteration: admit + prefill (applying any swap
        restores the plan scheduled), dispatch one decode step over all
        running, observe it synchronously."""
        self.drain()    # synchronous semantics if stages interleaved
        preempted = self.sched.plan_decode(now)
        self.stats["preemptions"] += len(preempted)
        prefills = self.sched.plan_prefills(now)
        self.caches = drain_cache_ops(self.caches, self.sched,
                                      self.swap_store, self.page_size)
        if prefills:
            self._run_prefill(prefills, now)
        # recomputed after prefill so every request whose context
        # completed this step joins the decode batch in the same iteration
        decodes = [r for r in self.sched.running
                   if r.state == "running" and not r.budget_spent]
        if decodes:
            self._dispatch_decode(decodes)
            self.drain()
        n0 = len(self.finished)
        self._finish_done()
        n_done = len(self.finished) - n0
        self._emitted.clear()      # step() reports counts, not streams
        self._update_stats()
        return {"prefilled": len(prefills), "decoded": len(decodes),
                "finished": n_done, "preempted": len(preempted)}

    def run(self, realtime: bool = False) -> List[Request]:
        """Drain all submitted requests and return the ones finished by
        *this* call.  ``realtime=True`` honours request arrival times
        against the wall clock."""
        n0 = len(self.finished)
        if self._t0 is None:     # keep one clock base across run() calls
            self._t0 = time.perf_counter()
        while self.has_work():
            now = self._wall() if realtime else float("inf")
            self.step(now=now)
            if realtime and not self.sched.running \
                    and self.sched.waiting:
                wait = self.sched.waiting[0].arrival - self._wall()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return self.finished[n0:]
