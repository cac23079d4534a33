"""Device and idle time of a traced run, split by the program's own
ranges.

The program names its layer boundaries in the profiler's trace (its
``tracing`` module): ``train.*`` around a training step's phases,
``model.*`` around each block's attention (``model.attn.<kind>``), MLP
and the head, ``<region>.bwd`` around their backward (on the thread
autograd runs it on), and ``engine.*`` around a serving step's phases.
This module reduces a ``trace.Trace``'s public lists (``kernels``,
``runtime``, ``ranges``, ``host``) by those names; it imports nothing of
the program.  A kernel belongs to a range by its host launch: the
``cudaLaunch*`` call that ``correlation`` ties it to.  Device seconds are
the union of the attributed kernels' intervals inside the traced window.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Tuple

Interval = Tuple[float, float]

TRAIN_BACKWARD = "train.backward"
TRAIN_OPTIMIZER = "train.optimizer"
MODEL = "model."
BWD = ".bwd"
SWA = ("model.attn.swa", "model.attn.swa.bwd")
ENGINE = "engine."
ENGINE_STEP = "engine.step"
DISPATCH = ("engine.prefill.dispatch", "engine.decode.dispatch")


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint union of ``intervals``."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length_s(intervals: Iterable[Interval]) -> float:
    """Seconds covered by the union of ``intervals`` (microseconds)."""
    return sum(b - a for a, b in merge(intervals)) / 1e6


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """Intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def launches(t) -> List[Tuple[float, float, float, object]]:
    """(start, end, launch time, launching thread) of every device
    operation in the window, clipped to it; operations without a host
    launch event are left out."""
    out = []
    for a, b, _, corr in t.kernels:
        a, b = max(a, t.t0), min(b, t.t1)
        launch = t.runtime.get(corr)
        if b > a and launch is not None:
            out.append((a, b, launch[0], launch[1]))
    return out


def has_range(t, pred) -> bool:
    return any(pred(name) and rs for name, rs in t.ranges.items())


def launched_under(t, name: str) -> Optional[float]:
    """Device seconds of the operations launched while a ``name`` range
    was open on any host thread; None without such a range."""
    spans = merge((a, b) for a, b, _ in t.ranges.get(name, ()))
    if not spans:
        return None
    starts = [a for a, _ in spans]
    hit = []
    for a, b, ts, _ in launches(t):
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1]:
            hit.append((a, b))
    return length_s(hit)


def innermost(t, prefix: str):
    """For every device operation of :func:`launches`: (start, end,
    launch time, the innermost range whose name starts with ``prefix``
    open on its launching thread at the launch, as (start, end, name), or
    None)."""
    by_tid: Dict[object, list] = collections.defaultdict(list)
    for name, rs in t.ranges.items():
        if name.startswith(prefix):
            for a, b, tid in rs:
                by_tid[tid].append((a, -b, name))
    for v in by_tid.values():
        v.sort()
    queries: Dict[object, list] = collections.defaultdict(list)
    for a, b, ts, tid in launches(t):
        queries[tid].append((ts, a, b))
    out = []
    for tid, qs in queries.items():
        rs, k, stack = by_tid.get(tid, []), 0, []
        for ts, a, b in sorted(qs):
            while k < len(rs) and rs[k][0] <= ts:
                s, neg_e, name = rs[k]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((s, -neg_e, name))
                k += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out.append((a, b, ts, stack[-1] if stack else None))
    return out


def train_split(t) -> Optional[Dict[str, float]]:
    """Device seconds of a traced training window by the program's
    ranges: ``backward`` and ``optimizer`` (launched under
    ``train.backward`` / ``train.optimizer``, any thread); ``recompute``
    (innermost ``model.*`` range a forward one that opened inside
    ``train.backward``); ``swa_attn`` (innermost ``model.*`` range
    ``model.attn.swa`` or its ``.bwd``); ``model_in_backward`` (launched
    under ``train.backward`` with some ``model.*`` range innermost); and
    each innermost ``model.*`` name.  None without ``train.*`` or
    ``model.*`` ranges."""
    if not has_range(t, lambda n: n.startswith("train.")) \
            or not has_range(t, lambda n: n.startswith(MODEL)):
        return None
    bwd = merge((a, b) for a, b, _ in t.ranges.get(TRAIN_BACKWARD, ()))
    starts = [a for a, _ in bwd]

    def in_backward(ts: float) -> bool:
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= bwd[i][1]

    acc: Dict[str, list] = collections.defaultdict(list)
    for a, b, ts, r in innermost(t, MODEL):
        if r is None:
            continue
        name = r[2]
        acc[name].append((a, b))
        if name in SWA:
            acc["swa_attn"].append((a, b))
        if not name.endswith(BWD) and in_backward(r[0]):
            acc["recompute"].append((a, b))
        if in_backward(ts):
            acc["model_in_backward"].append((a, b))
    out = {k: length_s(v) for k, v in acc.items()}
    for key in ("recompute", "swa_attn", "model_in_backward"):
        out.setdefault(key, 0.0)
    out["backward"] = launched_under(t, TRAIN_BACKWARD) or 0.0
    out["optimizer"] = launched_under(t, TRAIN_OPTIMIZER) or 0.0
    return out


def host_segments(ranges: List[Tuple[float, float, str]]):
    """Disjoint (start, end, name) segments: in each, the innermost of
    the properly nested ``ranges`` that is open."""
    points = sorted({x for a, b, _ in ranges for x in (a, b)})
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, k, stack = [], 0, []
    for lo, hi in zip(points, points[1:]):
        while stack and stack[-1][1] <= lo:
            stack.pop()
        while k < len(rs) and rs[k][0] <= lo:
            stack.append(rs[k])
            k += 1
        if stack:
            out.append((lo, hi, stack[-1][2]))
    return out


def idle_intervals(t) -> List[Interval]:
    """The window's intervals in which no device operation ran."""
    edges = [t.t0] + [x for iv in t.busy_intervals() for x in iv] + [t.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def serve_idle_split(t) -> Optional[Dict[str, float]]:
    """The device's idle seconds in the window, by what the host's
    innermost ``engine.*`` range was meanwhile: ``dispatch`` (a prefill's
    or a decode step's launch), ``engine`` (the rest of ``engine.step``:
    plan, build, sync, retire), ``outside`` (no ``engine.step``), and
    ``idle`` (all of it).  Intervals are intersected exactly.  None
    without ``engine.step`` ranges."""
    steps = merge((a, b) for a, b, _ in t.ranges.get(ENGINE_STEP, ()))
    if not steps:
        return None
    ranges = [(a, b, name) for name, rs in t.ranges.items()
              if name.startswith(ENGINE) for a, b, _ in rs]
    dispatch = [(a, b) for a, b, name in host_segments(ranges)
                if name in DISPATCH]
    idle = idle_intervals(t)
    in_step = intersect(idle, steps)
    out = {"idle": length_s(idle), "dispatch": length_s(
        intersect(in_step, merge(dispatch)))}
    out["engine"] = length_s(in_step) - out["dispatch"]
    out["outside"] = out["idle"] - length_s(in_step)
    return out


def pct(part: Optional[float], whole: Optional[float]) -> Optional[float]:
    """``part`` ÷ ``whole`` in %; None when either is missing or
    ``whole`` is not positive."""
    if part is None or whole is None or whole <= 0:
        return None
    return 100.0 * part / whole
