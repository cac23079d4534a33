"""Least time of MoBA attention's forward and backward work in the
profiled steps ÷ the device time of everything launched under the
program's FlashMoBA forward (recomputes included) and backward, in %."""
from bench.readers import roofline_pct


def read(ctx):
    t = ctx.rec.get("trace")
    if t is None:
        return None
    fwd, bwd = t.device_s_in("flash_moba"), t.device_s_in("flash_moba_bwd")
    if fwd is None or bwd is None:
        return None
    return roofline_pct(ctx.rec["moba_least_s"] * ctx.rec["profiled_steps"],
                        fwd + bwd)
