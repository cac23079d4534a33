"""The window's wall inside the engine's prefills (``Engine.stats``'s
``prefill_s``) ÷ the window, in %."""


def read(ctx):
    return 100.0 * ctx.rec["stats"]["prefill_s"] / ctx.rec["window_s"]
