"""Host-side radix tree over token-id prefixes at page granularity.

One tree node = one physical page plus the token ids whose KV it caches
(up to ``page_size``; the last node of an inserted prefix may be
partial).  Because one KV page is exactly one routable MoBA block, a
matched page carries its cached centroid for free — sharing a prefix
deduplicates both KV storage *and* the router's query-key affinity work.

The tree never owns device memory: it holds one refcount per referenced
page in the scheduler's :class:`~repro_torch.serving.scheduler.PagePool`, so a
page stays resident while either the tree or any running sequence maps
it, and :meth:`evict` can only drop pages nothing else references
(``refcount == 1``).  All bookkeeping is pure host-side numpy/dict work;
the caller (scheduler) decides when to take additional refs for the
sequences it admits onto matched pages.

Matching semantics:

  * full-page steps require exact ``page_size``-token content equality
    (an O(1) dict hop per page on the token bytes);
  * one optional trailing *partial* match takes the longest common
    prefix with the best child — the caller must copy-on-write that
    page before writing into it, since its tail tokens diverge;
  * ``full_only=True`` suppresses the partial step (key-conv configs
    restore ring state from page-end tails, which only exist for fully
    written pages).

Insertion dedups by content: re-inserting an existing prefix touches
LRU clocks and takes no new pages; a node holding a partial page is
*upgraded* in place when a fuller copy of the same content arrives
(the old page loses the tree's ref, the fuller one gains it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _lcp(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common prefix of two int token arrays."""
    m = min(len(a), len(b))
    if m == 0:
        return 0
    neq = a[:m] != b[:m]
    return int(np.argmax(neq)) if neq.any() else m


class _Node:
    __slots__ = ("tokens", "page", "children", "parent", "last_used")

    def __init__(self, tokens: np.ndarray, page: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens            # int32 (count,), count <= page_size
        self.page = page                # physical page id (-1 = root)
        self.children: Dict[bytes, "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixTree:
    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node(np.zeros((0,), np.int32), -1, None)
        self._clock = 0                 # logical LRU clock
        self.evictions = 0

    def __len__(self) -> int:
        """Number of pages the tree references."""
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- match
    def match(self, tokens: np.ndarray, max_tokens: Optional[int] = None,
              full_only: bool = False, touch: bool = True
              ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: (pages, n_tokens).

        Walks exact full-page hops, then (unless ``full_only``) one
        partial hop on the best longest-common-prefix child; when
        ``n_tokens % page_size != 0`` the last returned page is that
        partially-matched page.  Takes no refs — the caller refs the
        pages it decides to map.  ``touch=False`` leaves LRU clocks
        alone (router peeks across shards must not refresh them)."""
        toks = np.asarray(tokens, np.int32)
        limit = len(toks) if max_tokens is None else min(len(toks),
                                                         max_tokens)
        ps = self.page_size
        node, pages, matched = self.root, [], 0
        while matched + ps <= limit:
            child = node.children.get(toks[matched:matched + ps].tobytes())
            if child is None or len(child.tokens) < ps:
                break
            pages.append(child.page)
            matched += ps
            node = child
            if touch:
                child.last_used = self._tick()
        if not full_only and matched < limit:
            rem = toks[matched:limit]
            best, best_len = None, 0
            for child in node.children.values():
                m = _lcp(child.tokens, rem)
                if m > best_len:
                    best, best_len = child, m
            if best is not None:
                pages.append(best.page)
                matched += best_len
                if touch:
                    best.last_used = self._tick()
        return pages, matched

    def match_len(self, tokens: np.ndarray,
                  max_tokens: Optional[int] = None,
                  full_only: bool = False) -> int:
        """LRU-neutral match length (router shard-affinity peek)."""
        return self.match(tokens, max_tokens, full_only, touch=False)[1]

    # ------------------------------------------------------------ insert
    def insert(self, tokens: np.ndarray, pages: List[int], alloc) -> None:
        """Register ``pages`` as caching the prefix ``tokens``.

        ``len(pages) == ceil(len(tokens)/page_size)``; only the last page
        may be partial.  Pages whose content the tree already holds are
        deduped (no new ref); a held partial page is upgraded in place
        when ``tokens`` extends it.  Each newly referenced page gets one
        ``alloc.ref``; an upgraded-away page loses its tree ref."""
        toks = np.asarray(tokens, np.int32)
        ps = self.page_size
        node = self.root
        for j, page in enumerate(pages):
            chunk = toks[j * ps:(j + 1) * ps]
            key = chunk.tobytes()
            child = node.children.get(key)
            if child is None:
                # an existing child already covering chunk (chunk is a
                # prefix of its tokens) also dedups; a *partial* child
                # that chunk extends is upgraded to the fuller page
                covering = upgrade = None
                for c in node.children.values():
                    m = _lcp(c.tokens, chunk)
                    if m == len(chunk) and len(c.tokens) >= len(chunk):
                        covering = c
                        break
                    if m == len(c.tokens) and len(c.tokens) < len(chunk):
                        upgrade = c
                if covering is not None:
                    child = covering
                elif upgrade is not None:
                    del node.children[upgrade.tokens.tobytes()]
                    alloc.deref(upgrade.page)
                    upgrade.tokens = chunk.copy()
                    upgrade.page = page
                    alloc.ref(page)
                    node.children[key] = upgrade
                    child = upgrade
                else:
                    child = _Node(chunk.copy(), page, node)
                    alloc.ref(page)
                    node.children[key] = child
            child.last_used = self._tick()
            node = child

    # ------------------------------------------------------------- evict
    def evict(self, alloc, n: int) -> int:
        """Drop up to ``n`` least-recently-used leaf pages that only the
        tree references (``refcount == 1``), returning each to the free
        list.  Interior nodes become evictable as their subtrees drain.
        Returns the number of pages actually freed."""
        freed = 0
        while freed < n:
            victims = [node for node in self._iter()
                       if not node.children
                       and alloc.refcount(node.page) == 1]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.last_used)
            del victim.parent.children[victim.tokens.tobytes()]
            alloc.deref(victim.page)
            freed += 1
            self.evictions += 1
        return freed

    def _iter(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())
