"""Host-side continuous-batching scheduler: request lifecycle + pages.

Pure bookkeeping — no torch.  The scheduler owns the refcounted page pool
and the authoritative block table (numpy); the engine snapshots the
table into device arrays each step.  Policies are deliberately simple
and documented:

  * admission: FIFO by arrival; a request is admitted when a sequence
    slot is free and the pool can cover its whole context plus one decode
    token.  Admission happens every step — new requests join the running
    batch without draining it (continuous batching).  With the prefix
    cache enabled, admission first matches the longest cached prefix in
    the radix tree (``serving/prefix_tree.py``) and maps those logical
    blocks onto the existing physical pages (refcount++; their cached
    centroids come for free) so only the suffix is prefilled; a
    partially-matched tail page is copy-on-write'd to a fresh page
    before the suffix writes into it.
  * growth: before each decode step every running sequence is guaranteed
    a slot for one more token; crossing a page boundary allocates a page
    (evicting cold unreferenced tree prefixes under pressure).
  * preemption: when the pool is exhausted the *youngest* running request
    is evicted.  With a host swap store its written pages (and key-conv
    ring row) are snapshotted to host memory and restored on
    re-admission; without one — or when the store is over its byte cap —
    its full context is requeued for recompute-prefill, which with
    greedy decoding reproduces the interrupted stream exactly (and with
    the prefix cache, the recompute itself hits the victim's own pages
    still referenced by the tree).

``stats["admitted"]`` counts admissions (a preempted request's replay
again) and ``stats["queue_wait_s"]`` the host-clock seconds each of them
spent on ``waiting`` since it last entered it (a request admitted
without having been queued, as the staged ``Engine.prefill`` may, adds
no wait).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.prefix_tree import PrefixTree


class ServingError(ValueError):
    """User-facing configuration error (unsupported arch, impossible
    sizing) — distinguishable from genuine internal ValueErrors so CLI
    entry points can report it cleanly without eating tracebacks."""


class UnsupportedFeatureError(ServingError):
    """A config/request needs a feature this engine build lacks (key-conv
    caches, an attention backend without paged support, a non-attention
    layer pattern).  Raised at admission time — engine construction or
    request submit — so a bad request fails fast with a structured
    (feature, reason) instead of crashing inside a jitted step."""

    def __init__(self, feature: str, reason: str):
        self.feature = feature
        self.reason = reason
        super().__init__(f"unsupported feature {feature!r}: {reason}")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # int32 (L,) original prompt
    max_new_tokens: int
    arrival: float = 0.0
    eos_id: Optional[int] = None
    # runtime state
    out: List[int] = dataclasses.field(default_factory=list)
    state: str = "waiting"              # waiting | prefill | prefilled |
    #                                     running | done
    #   "prefill": admitted under chunked prefill with context tokens
    #   still to cache; holds a slot and pages but does not decode yet.
    #   "prefilled": staged-API holding state — context fully cached and
    #   first token sampled (engine.prefill), awaiting engine.insert;
    #   holds its slot and pages but does not decode yet.
    slot: int = -1
    shard: int = -1                     # owning shard (sharded engine);
    #   -1 = single-host or context-parallel fallback
    cache_len: int = 0                  # tokens whose KV is in the cache
    #   and *observed* by the host; dispatch-ahead decode steps that are
    #   still in flight have written further — see ``dispatched``
    dispatched: int = 0                 # decode steps dispatched to the
    #   device but not yet observed (dispatch-ahead pipelining).  Each
    #   wrote one KV position past ``cache_len``; observation moves it
    #   into ``cache_len``/``out``.  Always 0 between synchronous steps.
    n_preempt: int = 0
    prefix_len: int = 0                 # tokens served from the prefix
    #   cache at the most recent admission (0 = no hit / cache off)
    swap_data: Optional[dict] = None    # host snapshot of a preempted
    #   sequence's pages/ring (engine.HostSwapStore), or None
    t_first: Optional[float] = None     # first-token wall time
    t_done: Optional[float] = None
    t_queued: Optional[float] = None    # host clock when it last entered
    #   ``Scheduler.waiting`` (submit or preemption requeue); None once
    #   admitted

    @property
    def context(self) -> np.ndarray:
        """Prompt plus generated-so-far: what a recompute-prefill feeds.
        The last generated token is included — prefilling it emits the
        *next* token, exactly where the evicted decode left off."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out, np.int32)])

    @property
    def done(self) -> bool:
        if len(self.out) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.out
                and self.out[-1] == self.eos_id)

    @property
    def budget_spent(self) -> bool:
        """Generation budget exhausted *counting in-flight steps*: a
        request whose observed tokens plus dispatched-ahead decode steps
        cover ``max_new_tokens`` (or that already hit EOS) must not
        enter another decode batch — the pipeline would overrun its
        reserved pages.  Equals :attr:`done` when nothing is in flight,
        so the synchronous driver is unchanged."""
        return (self.done
                or len(self.out) + self.dispatched >= self.max_new_tokens)


class PagePool:
    """Refcounted free-list allocator over ``num_pages`` physical pages.

    A page's refcount is the number of logical mappings onto it: one per
    sequence whose block table points at it, plus one if the prefix tree
    references it, plus a transient pin while a scheduled
    copy-on-write reads from it.  ``alloc`` hands out a page at
    refcount 1; ``deref`` returns it to the free list when the count
    hits zero.  Double-frees and out-of-range ids raise a shaped
    :class:`ServingError` instead of silently corrupting the free list.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros((num_pages,), np.int32)

    @property
    def available(self) -> int:
        return len(self._free)

    def _check(self, page) -> int:
        if not isinstance(page, (int, np.integer)) \
                or not 0 <= page < self.num_pages:
            raise ServingError(
                f"page id {page!r} out of range [0, {self.num_pages})")
        return int(page)

    def refcount(self, page: int) -> int:
        return int(self._ref[self._check(page)])

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def ref(self, page: int) -> None:
        page = self._check(page)
        if self._ref[page] <= 0:
            raise ServingError(
                f"page {page}: ref() on a free page (refcount 0)")
        self._ref[page] += 1

    def deref(self, page: int) -> bool:
        """Drop one reference; True when this freed the page."""
        page = self._check(page)
        if self._ref[page] <= 0:
            raise ServingError(
                f"page {page}: double free (refcount already 0)")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def release(self, pages: List[int]) -> None:
        """Deref every page in ``pages`` (a sequence's mapping list).
        Shared pages survive under their remaining references; a page
        id repeated beyond its refcount raises the double-free error."""
        for page in pages:
            self.deref(page)


# legacy name: pre-virtualization callers constructed the allocator
# directly; the refcounted pool is a drop-in superset
PageAllocator = PagePool


@dataclasses.dataclass
class StepPlan:
    prefills: List[Request]
    # requests already in the decode phase at *plan* time.  The engine
    # recomputes the authoritative decode batch after running prefills,
    # because requests whose final chunk (or one-shot prefill) lands this
    # step join decoding in the same iteration.
    decodes: List[Request]
    preempted: List[Request]


class Scheduler:
    def __init__(self, *, num_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int, max_prefill_batch: int = 4,
                 chunk_tokens: int = 0, prefix_cache: bool = False,
                 key_conv: bool = False, full_page_match: bool = False,
                 swap=None):
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages_per_seq = max_pages_per_seq
        self.max_prefill_batch = max_prefill_batch
        # chunked prefill: admit long prompts in fixed-token chunks spread
        # over engine steps (0 = whole-prompt prefill).  Pages for the
        # full context are still reserved at admission, so chunking
        # bounds per-step prefill *compute*, not memory — no new
        # deadlock conditions.
        self.chunk_tokens = chunk_tokens
        # key-conv configs restore ring-buffer state from per-page raw-key
        # tails, which only exist for fully written pages — their prefix
        # matches are rounded down to whole pages (full_only).  Quantized
        # pools (``full_page_match``) share the constraint for a
        # different reason: writing a suffix into a COW'd partial page
        # requantizes its shared tokens against a new scale, so only
        # fully written pages are bit-exact to share.
        self.key_conv = key_conv
        self.full_page_match = key_conv or full_page_match
        self.tree = PrefixTree(page_size) if prefix_cache else None
        self.swap = swap                # engine.HostSwapStore or None
        self.alloc = PagePool(num_pages)
        self.block_table = np.full((max_seqs, max_pages_per_seq), -1,
                                   np.int32)
        self._seq_pages: List[List[int]] = [[] for _ in range(max_seqs)]
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        self.waiting: Deque[Request] = collections.deque()
        self.running: List[Request] = []    # admission order (oldest first)
        # device-side cache ops this plan scheduled; the engine drains
        # them (take_cache_ops) and applies them before the step's first
        # prefill/decode write
        self._cache_ops: Dict[str, list] = {
            "copies": [], "restores": [], "ring_loads": []}
        self.stats = {"prefix_queries": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "prefix_prompt_tokens": 0,
                      "cow_copies": 0, "swap_saves": 0,
                      "swap_restores": 0, "swap_fallbacks": 0,
                      "admitted": 0, "queue_wait_s": 0.0}
        # dispatch-ahead hook: called once per plan before the first
        # preemption (and before the victim's pages are snapshotted), so
        # the engine can observe in-flight decode steps and retire
        # finished requests first — preemption then always sees
        # host-consistent state and may even become unnecessary
        self.before_preempt = None

    # ------------------------------------------------------------- intake
    def validate(self, req: Request) -> None:
        """Raise a shaped error when ``req`` can never be served by this
        scheduler's pool, no matter how empty it gets."""
        need = len(req.prompt) + req.max_new_tokens
        cap = self.max_pages_per_seq * self.page_size
        if need > cap:
            raise ServingError(
                f"request {req.rid}: prompt+gen {need} tokens "
                f"exceed per-sequence capacity {cap}")
        if self._pages_for(need) > self.alloc.num_pages:
            raise ServingError(
                f"request {req.rid} can never fit: needs "
                f"{self._pages_for(need)} pages, pool has "
                f"{self.alloc.num_pages}")

    def submit(self, req: Request) -> None:
        self.validate(req)
        req.t_queued = time.perf_counter()
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------- router metrics
    @property
    def committed_pages(self) -> int:
        """Pages currently mapped by running/prefilling sequences (shared
        pages count once per mapping — each mapping is real demand the
        sequence would otherwise allocate).  Tree-only pages are
        excluded: they are reclaimable, not load."""
        return sum(len(p) for p in self._seq_pages)

    @property
    def queued_pages(self) -> int:
        """Pages the waiting queue will need (whole context + 1 token
        each — the same reservation admission makes)."""
        return sum(self._pages_for(len(r.context) + 1)
                   for r in self.waiting)

    @property
    def load(self) -> int:
        """Router load metric: committed + queued page demand.  A pure
        function of scheduler state so least-loaded routing is
        deterministic for a given submission order."""
        return self.committed_pages + self.queued_pages

    def fits(self, req: Request) -> bool:
        """Whether this shard can ever serve ``req`` (same conditions
        ``submit`` enforces, as a predicate instead of a raise)."""
        need = len(req.prompt) + req.max_new_tokens
        return (need <= self.max_pages_per_seq * self.page_size
                and self._pages_for(need) <= self.alloc.num_pages)

    def peek_prefix(self, req: Request) -> int:
        """Tokens of ``req``'s context the prefix cache could serve,
        without touching LRU clocks or taking refs — the sharded
        router's shard-affinity signal."""
        if self.tree is None:
            return 0
        return self.tree.match_len(req.context,
                                   max_tokens=self._match_cap(req),
                                   full_only=self.full_page_match)

    # ------------------------------------------------------------ helpers
    def _pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def _match_cap(self, req: Request) -> int:
        """At least one context token must always be prefilled (its
        logits emit the next token), and key-conv / quantized-pool
        matches stop at whole pages (ring state restores from page-end
        tails; partial-page sharing would requantize shared tokens)."""
        cap = len(req.context) - 1
        if self.full_page_match:
            cap -= cap % self.page_size
        return cap

    def _alloc_page(self) -> Optional[int]:
        page = self.alloc.alloc()
        if page is None and self.tree is not None \
                and self.tree.evict(self.alloc, 1):
            page = self.alloc.alloc()
        return page

    def _grow_to(self, req: Request, n_tokens: int) -> bool:
        """Ensure req's block-table row covers ``n_tokens`` tokens."""
        pages = self._seq_pages[req.slot]
        while len(pages) < self._pages_for(n_tokens):
            page = self._alloc_page()
            if page is None:
                return False
            self.block_table[req.slot, len(pages)] = page
            pages.append(page)
        return True

    def _cow_tail(self, req: Request) -> bool:
        """Guarantee the page ``req`` writes next (its partially filled
        tail page) is exclusively owned, scheduling a device
        copy-on-write when it is shared.  False = pool exhausted (the
        caller preempts and retries).  Page-aligned positions always
        open a freshly allocated page, so only mid-page writes can hit a
        shared page."""
        # next write position counts dispatched-ahead steps still in
        # flight — they already wrote the positions past cache_len
        pos = req.cache_len + req.dispatched
        off = pos % self.page_size
        if off == 0:
            return True
        j = pos // self.page_size
        pages = self._seq_pages[req.slot]
        if j >= len(pages) or self.alloc.refcount(pages[j]) == 1:
            return True
        fresh = self._alloc_page()
        if fresh is None:
            return False
        # the sequence's own mapping ref on the shared source page
        # becomes the copy's pin — take_cache_ops derefs it at drain
        self._cache_ops["copies"].append((pages[j], fresh))
        self.stats["cow_copies"] += 1
        pages[j] = fresh
        self.block_table[req.slot, j] = fresh
        return True

    def _release(self, req: Request) -> None:
        slot = req.slot
        self.alloc.release(self._seq_pages[slot])
        self._seq_pages[slot] = []
        self.block_table[slot, :] = -1
        self._free_slots.append(slot)
        req.slot = -1

    def _preempt_youngest(self, spare: Request) -> Optional[Request]:
        """Evict the most recently admitted running request != spare.
        The victim's pages are swapped to the host store when one is
        attached and under its cap (restored at re-admission); otherwise
        its cached-so-far full pages are left to the prefix tree (when
        enabled) and the context requeued for recompute."""
        for victim in reversed(self.running):
            if victim is spare and len(self.running) > 1:
                continue
            # the before_preempt hook drained the pipeline, so the
            # victim's host state (cache_len, out) is authoritative —
            # an in-flight victim would lose unobserved tokens from its
            # swap snapshot and corrupt the observation bookkeeping
            assert victim.dispatched == 0, \
                f"preempting request {victim.rid} with " \
                f"{victim.dispatched} in-flight decode steps"
            self.running.remove(victim)
            saved = False
            if self.swap is not None and victim.cache_len > 0 \
                    and victim.slot >= 0:
                used = self._seq_pages[victim.slot][
                    :self._pages_for(victim.cache_len)]
                saved = self.swap.save(victim, used, victim.slot)
                self.stats["swap_saves" if saved
                           else "swap_fallbacks"] += 1
            if not saved:
                # recompute fallback: keep the victim's full pages
                # findable so its own re-prefill is a prefix hit
                self.note_cached(victim)
            self._release(victim)
            victim.state = "waiting"
            victim.cache_len = 0
            victim.n_preempt += 1
            victim.t_queued = time.perf_counter()
            self.waiting.appendleft(victim)
            return victim
        return None

    # ------------------------------------------------------- prefix cache
    def note_cached(self, req: Request, final: bool = False) -> None:
        """Register ``req``'s cached pages in the prefix tree so later
        requests can map them.  Mid-flight calls insert only fully
        written pages; ``final=True`` (at finish) additionally inserts
        the partial tail page.  No-op without the prefix cache."""
        if self.tree is None or req.slot < 0 or req.cache_len <= 0:
            return
        count = req.cache_len if final \
            else req.cache_len - req.cache_len % self.page_size
        if count <= 0:
            return
        pages = self._seq_pages[req.slot][:self._pages_for(count)]
        self.tree.insert(req.context[:count], pages, self.alloc)

    def take_cache_ops(self) -> Dict[str, list]:
        """Hand the engine this plan's device cache ops — COW page
        copies, swap restores, key-conv ring loads — to apply before the
        step's first write.  Copy sources were pinned when scheduled;
        their pins drop here (the freed ids cannot be reused before the
        engine executes the copies, because allocation only happens in
        the next ``plan_step``)."""
        ops = self._cache_ops
        self._cache_ops = {"copies": [], "restores": [], "ring_loads": []}
        for src, _ in ops["copies"]:
            self.alloc.deref(src)
        return ops

    # --------------------------------------------------------------- plan
    def admit(self, req: Request) -> bool:
        """Admission attempt: prefix-match, reserve pages for the whole
        context plus one decode token, map shared ones.  False =
        insufficient pages right now (the legacy planner's FIFO
        head-of-line blocks; the staged API retries after capacity
        frees).  The caller owns queue membership — ``req`` must NOT be
        on ``waiting`` (``plan_prefills`` pops it on success; the staged
        ``Engine.prefill`` admits arbitrary requests directly)."""
        if not self._free_slots:
            return False
        ctx = len(req.context)
        swapped = req.swap_data is not None
        matched_pages: List[int] = []
        matched = 0
        if self.tree is not None and not swapped:
            matched_pages, matched = self.tree.match(
                req.context, max_tokens=self._match_cap(req),
                full_only=self.full_page_match)
        n_full = matched // self.page_size
        full_pages = matched_pages[:n_full]
        partial_src = (matched_pages[n_full]
                       if matched % self.page_size else None)
        for p in full_pages:
            self.alloc.ref(p)
        need_fresh = self._pages_for(ctx + 1) - n_full
        short = need_fresh - self.alloc.available
        if short > 0 and self.tree is not None:
            self.tree.evict(self.alloc, short)
        if need_fresh > self.alloc.available:
            for p in full_pages:
                self.alloc.deref(p)
            return False
        req.slot = self._free_slots.pop()
        seq_pages = self._seq_pages[req.slot]
        for j, p in enumerate(full_pages):
            self.block_table[req.slot, j] = p
            seq_pages.append(p)
        if partial_src is not None:
            # eager copy-on-write: the tail page's content diverges past
            # ``matched``, and the suffix prefill writes into it this
            # very step — map a fresh copy, never the shared page
            fresh = self.alloc.alloc()
            self.alloc.ref(partial_src)          # pin until the copy runs
            self._cache_ops["copies"].append((partial_src, fresh))
            self.stats["cow_copies"] += 1
            self.block_table[req.slot, n_full] = fresh
            seq_pages.append(fresh)
        req.cache_len = matched
        req.prefix_len = matched
        if self.tree is not None and not swapped:
            self.stats["prefix_queries"] += 1
            self.stats["prefix_hits"] += int(matched > 0)
            self.stats["prefix_hit_tokens"] += matched
            self.stats["prefix_prompt_tokens"] += ctx
        if self.key_conv and matched:
            self._cache_ops["ring_loads"].append(
                (req.slot, full_pages[-1]))
        ok = self._grow_to(req, ctx + 1)
        assert ok, "admission checked page availability"
        if swapped:
            # engine restores pages + cache_len before this step's
            # prefill; the remaining suffix is exactly one token
            self._cache_ops["restores"].append(req)
            remaining = ctx - req.swap_data["n_tokens"]
        else:
            remaining = ctx - matched
        # chunked mode admits into the "prefill" phase; the engine
        # flips it to "running" once the final chunk is cached.
        req.state = ("prefill" if self.chunk_tokens
                     and remaining > self.chunk_tokens else "running")
        self.running.append(req)
        self.stats["admitted"] += 1
        if req.t_queued is not None:
            self.stats["queue_wait_s"] += time.perf_counter() - req.t_queued
            req.t_queued = None
        return True

    def plan_decode(self, now: float = float("inf")) -> List[Request]:
        """Growth half of the plan, callable at decode cadence without
        admitting anyone: every running sequence that will decode next
        step gets room for one more token — and exclusive ownership of
        the page it writes into (COW) — preempting from the back under
        pressure (oldest survives).  Requests whose generation budget is
        already covered by dispatched-ahead steps are skipped: they
        never decode again, so growing them would waste pages (and
        could preempt someone for nothing).  Returns the victims."""
        preempted: List[Request] = []
        drained = False
        for req in list(self.running):
            if req.state not in ("running", "prefill"):
                continue
            if req.state == "running" and req.budget_spent:
                continue
            while req.state in ("running", "prefill") and not (
                    self._cow_tail(req)
                    and (req.state != "running"
                         or self._grow_to(
                             req, req.cache_len + req.dispatched + 1))):
                if not drained and self.before_preempt is not None:
                    # observe the in-flight pipeline (retiring finished
                    # requests frees their pages) before evicting anyone
                    # — the retry below may then succeed without a
                    # victim, and any victim has nothing in flight
                    self.before_preempt()
                    drained = True
                    continue
                victim = self._preempt_youngest(spare=req)
                if victim is None or victim is req:
                    if victim is None:       # cannot happen: req holds pages
                        raise RuntimeError("page pool deadlock")
                    preempted.append(victim)
                    break
                preempted.append(victim)
        return preempted

    def plan_prefills(self, now: float = float("inf")) -> List[Request]:
        """Admission half of the plan, decoupled from decode cadence —
        the legacy ``step()`` calls it every iteration, the staged API
        not at all (``Engine.prefill`` admits directly)."""
        # 1. chunk continuation: admitted requests with context still to
        #    cache run their next chunk before any new admission (they
        #    already hold slots and pages); overflow waits a step.
        prefills: List[Request] = [r for r in self.running
                                   if r.state == "prefill"
                                   ][:self.max_prefill_batch]

        # 2. admission (FIFO, arrivals only): whole context + one decode
        #    token must fit (chunking spreads the *compute*, not the
        #    reservation); prefix hits map cached pages and reserve only
        #    the rest.
        while (self.waiting and self._free_slots
               and len(prefills) < self.max_prefill_batch
               and self.waiting[0].arrival <= now):
            req = self.waiting[0]
            if not self.admit(req):
                break                        # FIFO head-of-line blocking
            self.waiting.popleft()
            prefills.append(req)
        return prefills

    def plan_step(self, now: float = float("inf")) -> StepPlan:
        """Legacy one-shot plan: growth + admission in one call — kept
        as the compatibility surface over the decoupled halves."""
        preempted = self.plan_decode(now)
        prefills = self.plan_prefills(now)
        decodes = [r for r in self.running if r.state == "running"]
        return StepPlan(prefills=prefills, decodes=decodes,
                        preempted=preempted)

    # ------------------------------------------------------------- finish
    def finish(self, req: Request) -> None:
        """Retire a request.  Robust to requests that were preempted back
        to the waiting queue (no slot, no pages) — e.g. cancelled or
        finished-by-policy while waiting for re-admission."""
        if req.state == "done":
            return
        if req in self.running:
            self.running.remove(req)
            # leave the finished context findable: full pages plus the
            # partial tail survive under the tree's refs
            self.note_cached(req, final=True)
            self._release(req)
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        if self.swap is not None:
            self.swap.drop(req)
        req.state = "done"
