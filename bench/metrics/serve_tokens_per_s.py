"""Output tokens that became visible inside the window ÷ the window (its
start to the end of the last engine step inside it)."""


def read(ctx):
    return ctx.rec["tokens"] / ctx.rec["window_s"]
