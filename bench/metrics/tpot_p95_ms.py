"""p95, over the requests sent in the window, of (end − first token) /
(tokens − 1)."""
from bench.readers import p95


def read(ctx):
    v = p95(ctx.rec["tpot_s"])
    return None if v is None else v * 1e3
