"""Tokens decoded ÷ decode steps in the window (``Engine.stats``)."""


def read(ctx):
    st = ctx.rec["stats"]
    if not st.get("decode_steps"):
        return None
    return st["decode_tokens"] / st["decode_steps"]
