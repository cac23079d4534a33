"""Device time of the operations whose innermost ``model.*`` range on
the launching thread is a forward one that opened inside
``train.backward`` (remat's second forward) ÷ device busy time of the
profiled steps, in %."""
from bench import spans


def read(ctx):
    t = ctx.rec.get("trace")
    split = None if t is None else spans.train_split(t)
    return None if split is None else spans.pct(split["recompute"],
                                                t.busy_s)
