"""Device time of the operations launched while the program's
``train.backward`` range is open, on any host thread (autograd launches
the backward from its own) ÷ device busy time of the profiled steps, in
%."""
from bench import spans


def read(ctx):
    t = ctx.rec.get("trace")
    if t is None:
        return None
    return spans.pct(spans.launched_under(t, spans.TRAIN_BACKWARD),
                     t.busy_s)
