"""Seconds in which the device is idle while the host is inside
``engine.step`` and outside both dispatch ranges (planning, building,
syncing, retiring) ÷ the profiled sub-window of serving, in %."""
from bench import spans


def read(ctx):
    t = ctx.rec.get("trace")
    split = None if t is None else spans.serve_idle_split(t)
    return None if split is None else spans.pct(split["engine"],
                                                t.window_s)
