"""2·N × (prompt tokens prefilled + output tokens decoded in the window)
÷ the window ÷ the bf16 peak, in %."""
from bench import arith


def read(ctx):
    st = ctx.rec["stats"]
    tokens = st["prefill_tokens"] + st["decode_tokens"]
    return 100.0 * arith.forward_flops(ctx.config, tokens) \
        / ctx.rec["window_s"] / arith.PEAK_BF16_FLOPS
