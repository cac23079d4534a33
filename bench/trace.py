"""The reduction from a ``torch.profiler`` trace to the numbers the
per-layer metrics read.

A traced run profiles a short steady sub-window, marked by a
``bench.window`` range; spans that the runners open around calls into
the program are ``bench.<name>`` ranges (``torch.profiler.
record_function``).  The profiler's Chrome trace holds, per event, a
category: ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` on the device,
``cuda_runtime`` / ``cuda_driver`` for the host's CUDA calls,
``user_annotation`` for the ranges and ``cpu_op`` for operators.  A
kernel is tied to the host call that launched it by ``correlation``.
Times are microseconds.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def profiled():
    """Profile CPU and CUDA activity; yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def span(name: str):
    """A ``bench.<name>`` range around a call into the program."""
    import torch

    return torch.profiler.record_function(f"bench.{name}")


def events_of(prof) -> List[dict]:
    """The complete ("X") events of a finished profile."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def reduce(prof) -> Optional["Trace"]:
    """The ``Trace`` of a finished profile; None without one."""
    return None if prof is None else Trace(events_of(prof))


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one profiled sub-window."""

    def __init__(self, events: List[dict]):
        self.kernels, self.runtime, self.host = [], {}, []
        self.ranges = collections.defaultdict(list)
        win = None
        for e in events:
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.kernels.append((ts, ts + dur, e["name"], corr))
            elif cat in RUNTIME_CATS:
                self.runtime[corr] = (ts, e.get("tid"), e["name"])
            elif cat in HOST_CATS:
                self.host.append((ts, ts + dur, e["name"], e.get("tid")))
                if cat == "user_annotation":
                    if e["name"] == WINDOW and win is None:
                        win = (ts, ts + dur)
                    self.ranges[e["name"]].append((ts, ts + dur,
                                                   e.get("tid")))
        if win is None and self.kernels:
            win = (min(k[0] for k in self.kernels),
                   max(k[1] for k in self.kernels))
        self.t0, self.t1 = win or (0.0, 0.0)
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _in_window(self):
        for a, b, name, corr in self.kernels:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                yield a, b, name, corr

    def busy_intervals(self):
        return _merge([(a, b) for a, b, _, _ in self._in_window()])

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran, in the window."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_s_in(self, name: str) -> Optional[float]:
        """Device seconds of every operation launched inside a
        ``bench.<name>`` range (on the range's own host thread); None when
        no such range was recorded."""
        ranges = self.ranges.get(f"bench.{name}")
        if not ranges:
            return None
        by_tid = collections.defaultdict(list)
        for a, b, tid in ranges:
            by_tid[tid].append((a, b))
        for v in by_tid.values():
            v.sort()
        total = 0.0
        for a, b, _, corr in self.kernels:
            launch = self.runtime.get(corr)
            if launch is None:
                continue
            ts, tid, _ = launch
            rs = by_tid.get(tid, ())
            i = bisect.bisect_right(rs, (ts, float("inf"))) - 1
            if i >= 0 and rs[i][0] <= ts <= rs[i][1]:
                total += b - a
        return total / 1e6

    def notes(self) -> Dict[str, int]:
        """How many device operations the window holds, and how many of
        them have no host launch event to attribute them by."""
        ops = list(self._in_window())
        return {"device_ops": len(ops),
                "without_launch": sum(1 for *_, c in ops
                                      if c not in self.runtime)}

    def launch_calls(self) -> int:
        """Kernel launch calls of the host inside the window."""
        return sum(1 for ts, _, name in self.runtime.values()
                   if self.t0 <= ts <= self.t1
                   and (name.startswith("cudaLaunch")
                        or name.startswith("cuLaunch")))

    def top_device_ops(self, n: int = 10) -> List[list]:
        """[name, seconds] of the device operations that took most time."""
        acc: Dict[str, float] = collections.defaultdict(float)
        for a, b, name, _ in self._in_window():
            acc[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float, scan: int = 20000) -> str:
        """The innermost host operation or range running at ``t``."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(-1, i - scan), -1):
            a, b, name, _ = self.host[j]
            if a <= t <= b and name != WINDOW:
                return name
        return "(no host op)"

    def idle_gaps(self, n: int = 10, longest: int = 5000) -> List[list]:
        """[host operation, seconds]: the device's idle gaps in the
        window (the ``longest`` of them), summed by what the host was
        running at each gap's middle."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        acc: Dict[str, float] = collections.defaultdict(float)
        for dur, a in gaps[:longest]:
            acc[self._host_at(a + dur / 2)] += dur / 1e6
        return [[k, v] for k, v in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:n]]
