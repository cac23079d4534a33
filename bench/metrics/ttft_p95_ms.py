"""p95, over every request sent in the window, of send → first token."""
from bench.readers import p95


def read(ctx):
    v = p95(ctx.rec["ttft_s"])
    return None if v is None else v * 1e3
