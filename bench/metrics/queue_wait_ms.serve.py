"""Host-clock wait on the scheduler's queue per admission in the window
(``Engine.stats``'s ``queue_wait_s`` ÷ ``admitted``), in ms."""


def read(ctx):
    st = ctx.rec.get("stats") or {}
    if not st.get("admitted"):
        return None
    return 1e3 * st["queue_wait_s"] / st["admitted"]
