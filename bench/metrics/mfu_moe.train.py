"""Model FLOPs of the window's steps ÷ the window ÷ the bf16 peak, in %,
for a latent-attention MoE configuration, with the routed experts' work
counted from the program's routing counter.

6 FLOPs a parameter and token of every matrix a token goes through
(latent attention's W_q, W_kv_a, W_kv_b, W_o, the dense layer's SwiGLU,
each MoE layer's router and shared experts, the head), plus 6 · 3 · d ·
f for each (token, held expert) pair the counter gives: the same 6·N·D
as ``mfu.train`` (attention's scores are not counted), with N the
parameters each token really used.  None without the counter."""
from bench import arith


def per_token_params(cfg: dict) -> int:
    """Matrix parameters every token goes through, held experts aside."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    attn = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    shared = 3 * d * cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
    router = d * cfg["published"]["n_routed_experts"]
    return (cfg["num_hidden_layers"] * attn
            + dense * 3 * d * cfg["intermediate_size"]
            + moe * (shared + router) + d * cfg["vocab_size"])


def window_flops(cfg: dict, tokens: int, held_pairs: float) -> float:
    pair = 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    return 6.0 * (per_token_params(cfg) * tokens + pair * held_pairs)


def read(ctx):
    routing = ctx.rec.get("routing")
    if routing is None:
        return None
    flops = window_flops(ctx.config, ctx.rec["tokens"],
                         routing["held_pairs"])
    return 100.0 * flops / ctx.rec["window_s"] / arith.PEAK_BF16_FLOPS
