"""``torch.cuda.max_memory_allocated`` over the window, in GiB."""


def read(ctx):
    b = ctx.rec.get("peak_window_bytes")
    return None if b is None else b / 2 ** 30
