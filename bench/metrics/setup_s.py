"""Process start → window open: weights, build, warm-up, first steps."""


def read(ctx):
    return ctx.rec["setup_s"]
