"""Helpers the metric readers of ``metrics/`` share.

A reader is ``metrics/<metric name>.py`` with ``read(ctx)``, returning
the metric's value or None when its run holds nothing for it (the
harness then leaves the metric out of the line).  ``ctx`` carries the
run's ``config`` and ``traffic`` (dicts) and ``rec``, the records the
runner took: host-clock times and counts, the program's counter deltas
(``stats``) and, in a traced run, ``trace`` (``trace.Trace``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile by nearest rank; a failed request is +inf."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def idle_pct(ctx) -> Optional[float]:
    """The device's idle share of the traced window, in %."""
    t = ctx.rec.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(least_s, device_s) -> Optional[float]:
    """Least time over device time, in %; None without device time."""
    if least_s is None or not device_s:
        return None
    return 100.0 * least_s / device_s
