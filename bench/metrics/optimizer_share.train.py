"""Device time of the operations launched while the program's
``train.optimizer`` range is open ÷ device busy time of the profiled
steps, in %."""
from bench import spans


def read(ctx):
    t = ctx.rec.get("trace")
    if t is None:
        return None
    return spans.pct(spans.launched_under(t, spans.TRAIN_OPTIMIZER),
                     t.busy_s)
