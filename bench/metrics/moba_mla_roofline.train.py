"""Least time of MoBA attention's forward and backward work at latent
attention's widths in the profiled steps ÷ the device time of everything
launched under the program's ``kernel.flash_moba`` (forward, recomputes
included) and ``kernel.flash_moba_bwd`` ranges, in %.

``moba_roofline.train``'s conventions (``arith.moba_train_work``) with
q/k ``qk_nope_head_dim + qk_rope_head_dim`` wide and v ``v_head_dim``:
routing 2·d_qk a query head and causal block, QKᵀ 2·d_qk and PV 2·d_v a
query head and selected key forward; the backward 2.5× the forward's
attention; bytes q, k, v read and o written forward, q, k, v, o, dO read
and dq, dk, dv written backward, each once, bf16, with every head's own
key (its RoPE part copied to each head, as the program holds it).  One
forward and one backward a layer and step.  None where the program has
no such ranges."""
from bench import arith, spans
from bench.readers import roofline_pct


def mla_moba_least_s(cfg: dict, rows: int, seq: int,
                     el_bytes: int = 2) -> float:
    """Least seconds of one training step's MoBA attention at latent
    attention's widths, every layer's forward and backward."""
    m, h = cfg["moba"], cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    keys, blocks = arith._keys_attended(seq, m["block_size"], m["top_k"])
    qk_el, v_el = rows * h * seq * dqk, rows * h * seq * dv
    fwd = arith.least_time(rows * h * ((2 * dqk + 2 * dv) * keys
                                       + 2 * dqk * blocks),
                           (2 * qk_el + 2 * v_el) * el_bytes)
    bwd = arith.least_time(rows * h * 2.5 * (2 * dqk + 2 * dv) * keys,
                           (4 * qk_el + 4 * v_el) * el_bytes)
    return cfg["num_hidden_layers"] * (fwd + bwd)


def read(ctx):
    t = ctx.rec.get("trace")
    if t is None:
        return None
    fwd = spans.launched_under(t, "kernel.flash_moba")
    bwd = spans.launched_under(t, "kernel.flash_moba_bwd")
    if fwd is None or bwd is None:
        return None
    tr = ctx.traffic
    least = mla_moba_least_s(ctx.config, tr["rows"], tr["seq_len"])
    return roofline_pct(least * ctx.rec["profiled_steps"], fwd + bwd)
