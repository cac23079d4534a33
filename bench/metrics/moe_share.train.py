"""Device time of the MoE layers' routing, dispatch, held experts,
combine and shared experts, forward, recompute and backward (innermost
``model.*`` range on the launching thread a ``model.moe.*`` one, its
``.bwd`` included) ÷ device busy time of the profiled steps, in %.  None
where the program has no such ranges."""
from bench import spans


def read(ctx):
    t = ctx.rec.get("trace")
    if t is None or not spans.has_range(
            t, lambda n: n.startswith("model.moe.")):
        return None
    moe = [(a, b) for a, b, _, r in spans.innermost(t, spans.MODEL)
           if r is not None and r[2].startswith("model.moe.")]
    return spans.pct(spans.length_s(moe), t.busy_s)
