"""6·N·D of the window's steps ÷ the window ÷ the bf16 peak, in %."""
from bench import arith


def read(ctx):
    tr = ctx.traffic
    flops = arith.train_flops(ctx.config, tr["rows"], tr["seq_len"])
    return 100.0 * flops * ctx.rec["steps"] / ctx.rec["window_s"] \
        / arith.PEAK_BF16_FLOPS
