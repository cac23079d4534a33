"""Step-time heartbeat monitor — straggler detection for large jobs.

At 1000+ chips the SPMD program is a global barrier per step, so a single
slow host shows up as elongated step wall-time for *everyone*.  The
monitor keeps a rolling step-time distribution and flags:

  * **stragglers** — steps slower than ``threshold ×`` the rolling median
    (on a real cluster each host exports its own timings; the controller
    compares across hosts to localize the slow one),
  * **stalls** — no heartbeat within ``stall_timeout`` seconds, the signal
    to trigger the checkpoint-restart path (the reference's
    ``train.py --resume auto``; checkpointing is not ported yet, see
    ROADMAP.md).

The response ladder on a real pod, in escalation order: (1) log + export
the flag, (2) exclude the host's data shard at the next step (input
pipeline is host-local and deterministic so this is a pure re-shard),
(3) evict the slice at the next checkpoint boundary and restart elastic.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, List, Optional


class HeartbeatMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 stall_timeout: float = 300.0,
                 on_straggler: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.window = window
        self.threshold = threshold
        self.stall_timeout = stall_timeout
        self.on_straggler = on_straggler
        self._clock = clock
        self._times = collections.deque(maxlen=window)
        self._last_beat = None
        self.straggler_steps: List[int] = []

    def beat(self, step: int) -> Optional[float]:
        """Call once per completed step; returns the step duration."""
        now = self._clock()
        if self._last_beat is None:
            self._last_beat = now
            return None
        dt = now - self._last_beat
        self._last_beat = now
        if len(self._times) >= 5:
            med = statistics.median(self._times)
            if dt > self.threshold * med:
                self.straggler_steps.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self._times.append(dt)
        return dt

    def is_stalled(self) -> bool:
        if self._last_beat is None:
            return False
        return (self._clock() - self._last_beat) > self.stall_timeout

    @property
    def median_step_time(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None

    def summary(self) -> dict:
        return {
            "steps_observed": len(self._times),
            "median_s": self.median_step_time,
            "p99_s": (sorted(self._times)[int(0.99 * (len(self._times) - 1))]
                      if self._times else None),
            "stragglers": list(self.straggler_steps),
        }
