"""Tokens of every step started in the window ÷ the window (its start to
the synchronised end of the last of those steps)."""


def read(ctx):
    return ctx.rec["tokens"] / ctx.rec["window_s"]
