"""The largest held expert's pairs over the mean held expert's, from the
program's routing counter over the window: per MoE layer, then the mean
over the layers.  1 is perfect balance.  None without the counter."""


def read(ctx):
    routing = ctx.rec.get("routing")
    if routing is None:
        return None
    ratios = [max(row) / (sum(row) / len(row))
              for row in routing["held_by_layer"] if sum(row) > 0]
    return sum(ratios) / len(ratios) if ratios else None
