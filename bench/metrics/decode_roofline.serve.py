"""Least time of the paged MoBA decode attention these inputs need ÷ the
device time of everything launched under the program's decode call, in
the profiled sub-window, in %."""
from bench.readers import roofline_pct


def read(ctx):
    t = ctx.rec.get("trace")
    if t is None:
        return None
    return roofline_pct(ctx.rec.get("decode_least_s"),
                        t.device_s_in("moba_decode"))
