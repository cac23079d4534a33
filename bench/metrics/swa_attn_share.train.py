"""Device time of the SWA layers' attention, forward, recompute and
backward (innermost ``model.*`` range on the launching thread
``model.attn.swa`` or ``model.attn.swa.bwd``) ÷ device busy time of the
profiled steps, in %."""
from bench import spans


def read(ctx):
    t = ctx.rec.get("trace")
    split = None if t is None else spans.train_split(t)
    return None if split is None else spans.pct(split["swa_attn"],
                                                t.busy_s)
