"""Kernel launch calls of the host ÷ decode steps, in the profiled
sub-window."""


def read(ctx):
    t, steps = ctx.rec.get("trace"), ctx.rec.get("profiled_decode_steps")
    if t is None or not steps:
        return None
    return t.launch_calls() / steps
