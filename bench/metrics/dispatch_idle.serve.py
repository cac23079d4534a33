"""Seconds in which the device is idle while the host's innermost
``engine.*`` range is a prefill's or a decode step's dispatch ÷ the
profiled sub-window of serving, in %."""
from bench import spans


def read(ctx):
    t = ctx.rec.get("trace")
    split = None if t is None else spans.serve_idle_split(t)
    return None if split is None else spans.pct(split["dispatch"],
                                                t.window_s)
