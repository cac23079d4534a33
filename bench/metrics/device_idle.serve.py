"""1 − device busy time ÷ the profiled sub-window of serving, in %."""
from bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
