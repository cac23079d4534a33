"""Least time of the SWA layers' attention in the profiled steps ÷ the
device time of everything launched under the program's ``kernel.swa``
(forward, recomputes included) and ``kernel.swa_bwd`` ranges, in %.

The work, as ``arith.moba_train_work`` counts MoBA's, summed over the
SWA layers of a step: query t attends min(t + 1, window) keys; 4·d FLOPs
a query head and key forward (QKᵀ, PV), 10·d backward; bytes q, k, v
read and o written forward, q, k, v, o, dO read and dq, dk, dv written
backward, each once, in bf16.  One forward and one backward per layer
and step: remat's second forward is in the device time, not the work, as
in ``moba_roofline.train``.  None where the program has no such ranges."""
from bench import arith, spans
from bench.readers import roofline_pct


def swa_train_least_s(cfg: dict, rows: int, seq: int,
                      el_bytes: int = 2) -> float:
    """Least seconds of one training step's SWA attention on the card:
    each layer's forward and backward at the larger of FLOPs at the bf16
    peak and bytes at the HBM peak."""
    pattern = cfg["layer_pattern"]
    layers = cfg["num_layers"] // len(pattern) * pattern.count("swa")
    d, h, hkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    dh = cfg["head_dim"] or d // h
    window = cfg["attention"]["window"]
    keys = sum(min(t + 1, window) for t in range(seq))
    q_el, kv_el = rows * h * seq * dh, rows * hkv * seq * dh
    fwd = arith.least_time(rows * h * 4 * dh * keys,
                           (2 * q_el + 2 * kv_el) * el_bytes)
    bwd = arith.least_time(rows * h * 10 * dh * keys,
                           (4 * q_el + 4 * kv_el) * el_bytes)
    return layers * (fwd + bwd)


def read(ctx):
    t = ctx.rec.get("trace")
    if t is None:
        return None
    fwd = spans.launched_under(t, "kernel.swa")
    bwd = spans.launched_under(t, "kernel.swa_bwd")
    if fwd is None or bwd is None:
        return None
    tr = ctx.traffic
    least = swa_train_least_s(ctx.config, tr["rows"], tr["seq_len"])
    return roofline_pct(least * ctx.rec["profiled_steps"], fwd + bwd)
