"""Mixture-of-Experts MLPs: GShard-style capacity-based dispatch
(:func:`apply_moe`), and DeepSeek-V3's dropless sigmoid routing over the
experts one device holds (:func:`apply_held_moe`).

The reference's formulation, step for step: a fp32 router, top-k experts
per token in ``lax.top_k``'s order, renormalised top-k weights, each
(token, slot) pair's position in its expert's capacity buffer from a
cumsum over the pairs in token-major order, pairs past the capacity
dropped into a spare expert row that is discarded, every expert's SwiGLU
as one batched product over the (E, capacity, d) buffer, the gather
back, shared experts, and the Switch Transformer load-balance loss.

Every shape of :func:`apply_moe` is known on the host and nothing reads
a device value back, so a decode step enqueues without a sync.  No
kernel: the reference runs all of this outside Pallas, and here it is
``torch`` products and indexing.

:func:`apply_held_moe` computes every pair routed to a held expert
whatever the imbalance: the pairs are sorted by expert and the held
experts' SwiGLUs run as grouped products (``torch._grouped_mm``, whose
row groups end where the device says) over a buffer of a row count fixed
on the host, the rows past the held pairs masked.  The layer reads
nothing back.  In training the buffer holds a few times the held pairs
of even routing (:func:`held_bound`); a call whose pairs outgrow it marks
a flag on the device, which the training step reads once, before its
optimizer, and then takes its gradients again over every pair
(``transformer.train_functions``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.routing import topk_desc
from repro_torch.models.layers import apply_mlp, wcast


def capacity(tokens: int, cfg: ModelConfig,
             capacity_factor: float = 1.25) -> int:
    """Slots per expert: drop-free (``tokens·k``) up to 64 tokens, so a
    decode step routes as its prefill did; else ``1.25·tokens·k/E``."""
    m = cfg.moe
    if tokens <= 64:
        return tokens * m.top_k
    return max(int(capacity_factor * tokens * m.top_k / m.num_experts), 1)


def moe_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of one MoE layer's params (``init_moe``)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    shapes = {"router": (d, e),
              "experts": {"w_gate": (e, d, f), "w_up": (e, d, f),
                          "w_down": (e, f, d)}}
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        shapes["shared"] = {"w_gate": (d, fs), "w_up": (d, fs),
                            "w_down": (fs, d)}
    return shapes


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = ()) -> dict:
    """Random fp32 leaves ~ N(0, 1/fan_in), the reference's scales (the
    draws differ).  ``lead`` prepends the layer-group axis; each leaf is
    drawn whole and scaled in place, so a full-size model never holds a
    second copy of its largest leaf."""
    def draw(shape, fan_in):
        return torch.randn(lead + shape, generator=gen,
                           device=gen.device).mul_(fan_in ** -0.5)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else draw(v, v[-2]) for k, v in t.items()}

    return walk(moe_shapes(cfg))


def route(router: torch.Tensor, xf: torch.Tensor, k: int):
    """fp32 router over tokens xf (T, d): (probs (T, E), renormalised
    top-k weights (T, k), experts (T, k)) in ``lax.top_k``'s order."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    top_p, top_e = topk_desc(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def expert_slots(top_e: torch.Tensor, num_experts: int, cap: int):
    """Each (token, slot) pair's position in its expert's buffer: the
    pairs in token-major order, each counting the earlier pairs that
    chose its expert.  Returns (one-hot (T, k, E) int32, positions (T,
    k), keep (T, k): the pairs within ``cap``)."""
    t, k = top_e.shape
    onehot = (top_e[..., None] == torch.arange(num_experts,
                                               device=top_e.device)
              ).to(torch.int32)
    flatoh = onehot.reshape(t * k, num_experts)
    pos = (torch.cumsum(flatoh, dim=0) - flatoh).reshape(t, k, num_experts)
    pos = (pos * onehot).sum(-1)
    return onehot, pos, pos < cap


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss, a 0-d fp32 tensor).

    All B·S tokens share the capacity, padding rows included, as in the
    reference: two prompts prefilled together can drop each other's
    pairs."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    tokens = b * s
    cap = capacity(tokens, cfg, capacity_factor)
    dt = x.dtype

    xf = x.reshape(tokens, d)
    probs, top_p, top_e = route(p["router"], xf, k)
    onehot, pos, keep = expert_slots(top_e, e, cap)
    # dropped pairs land in the spare row e, which is discarded; the
    # kept pairs' (expert, position) are unique by construction
    dst_e = torch.where(keep, top_e, e)
    dst_c = torch.where(keep, pos, 0)
    flat = (dst_e * cap + dst_c).reshape(-1)                   # (T·k,)
    buf = xf.new_zeros(((e + 1) * cap, d)).index_add(
        0, flat, xf.repeat_interleave(k, dim=0))
    expert_in = buf[:e * cap].reshape(e, cap, d)

    w = p["experts"]
    h = (torch.nn.functional.silu(torch.bmm(expert_in,
                                            wcast(w["w_gate"], dt)))
         * torch.bmm(expert_in, wcast(w["w_up"], dt)))
    expert_out = torch.bmm(h, wcast(w["w_down"], dt)).reshape(e * cap, d)

    back = (torch.clamp(dst_e, max=e - 1) * cap + dst_c).reshape(-1)
    slots = expert_out[back].reshape(tokens, k, d)
    slots = slots * keep[..., None].to(dt)                     # (T, k, d)
    out = torch.einsum("tk,tkd->td", top_p.to(dt), slots)

    if m.num_shared_experts and "shared" in p:
        out = out + apply_mlp(p["shared"], xf)

    # Switch aux loss: E · Σ_e (fraction of pairs to e · mean prob of e);
    # the fraction counts dropped pairs too
    frac = onehot.float().sum((0, 1)) / (tokens * k)
    aux = e * torch.sum(frac * probs.mean(0)) * m.router_aux_coef
    return out.reshape(b, s, d), aux


# ------------------------------------------- sigmoid routing, held experts
def held_moe_shapes(cfg) -> dict:
    """Leaf shapes of one sigmoid-routed MoE layer holding
    ``cfg.held_experts`` (a ``LatentMoEConfig``): the router over every
    expert, the held experts' SwiGLU stacks and the shared experts as one
    SwiGLU of ``num_shared_experts`` times the expert width."""
    m = cfg.moe
    d, f, held = cfg.d_model, m.expert_d_ff, cfg.held_experts[1]
    fs = f * m.num_shared_experts
    return {"router": (d, m.num_experts),
            "experts": {"w_gate": (held, d, f), "w_up": (held, d, f),
                        "w_down": (held, f, d)},
            "shared": {"w_gate": (d, fs), "w_up": (d, fs),
                       "w_down": (fs, d)}}


def sigmoid_route(router: torch.Tensor, xf: torch.Tensor,
                  bias: torch.Tensor, k: int, scale: float):
    """fp32 sigmoid scores s (T, E) of tokens xf (T, d); the top ``k``
    experts on s + ``bias`` in ``lax.top_k``'s order (T, k); their
    weights ``scale`` · s / Σ of the chosen s (T, k)."""
    s = torch.sigmoid(xf.float() @ router.float())
    _, top_e = topk_desc(s + bias, k)
    top_s = s.gather(-1, top_e)
    return s, top_e, top_s * (scale / top_s.sum(-1, keepdim=True))


def seq_balance_loss(s: torch.Tensor, top_e: torch.Tensor, rows: int,
                     coef: float) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance loss over ``rows`` sequences
    of the tokens: per row coef · Σ_i f_i · P_i with f_i = E/(k·T) · the
    row's tokens that chose i and P_i the row's mean of s_i / Σ_j s_j,
    averaged over the rows."""
    t, e = s.shape
    k = top_e.shape[-1]
    per = t // rows
    chosen = torch.zeros((rows, e), device=s.device).scatter_add_(
        1, top_e.reshape(rows, per * k),
        torch.ones((rows, per * k), device=s.device))
    f = chosen * (e / (k * per))
    p = (s / s.sum(-1, keepdim=True)).reshape(rows, per, e).mean(1)
    return coef * (f * p).sum(-1).mean()


# A bounded buffer's rows over the held pairs of even routing: a call
# whose pairs outgrow it costs its step a second pass, its rows past them
# cost every call their masked elementwise work.  Early in training a
# layer call's held pairs reach 2.3x even routing's and move by more than
# a quarter from one step to the next (Moonlight-16B-A3B's share, 8K
# rows), so the bound is fixed and generous.
HELD_SLACK = 4.0


def held_bound(tokens: int, cfg) -> int:
    """Rows of a bounded dispatch buffer for ``tokens`` tokens:
    :data:`HELD_SLACK` times the pairs the held experts get under even
    routing, in multiples of 16 (at most every pair)."""
    m = cfg.moe
    pairs = tokens * m.top_k
    even = pairs * cfg.held_experts[1] / m.num_experts
    return min(pairs, 16 * -(-int(HELD_SLACK * even) // 16))


def sort_held(top_e: torch.Tensor, first: int, held: int):
    """The (token, slot) pairs sorted by expert, those routed to held
    experts ``first`` .. ``first + held - 1`` first: (every pair's index
    into the flattened (T·k) pairs in that order, each held expert's
    cumulative end (held,) int32; the last is the held pairs' count, on
    the device)."""
    local = top_e.reshape(-1) - first
    key = torch.where((local >= 0) & (local < held), local, held)
    ends = torch.cumsum(torch.bincount(key, minlength=held + 1)[:held], 0)
    return torch.argsort(key, stable=True), ends.to(torch.int32)


def grouped_swiglu(w: dict, a: torch.Tensor, ends: torch.Tensor
                   ) -> torch.Tensor:
    """Every held expert's SwiGLU over its rows of ``a`` (rows grouped by
    expert, expert i's ending at ``ends[i]``): three grouped products.
    Rows past ``ends[-1]`` are left unwritten, forward and backward."""
    dt = a.dtype
    gmm = torch._grouped_mm
    h = (torch.nn.functional.silu(gmm(a, wcast(w["w_gate"], dt), offs=ends))
         * gmm(a, wcast(w["w_up"], dt), offs=ends))
    return gmm(h, wcast(w["w_down"], dt), offs=ends)


def apply_held_moe(p: dict, x: torch.Tensor, cfg, bias: torch.Tensor,
                   bound: int = 0, over: torch.Tensor = None):
    """One sigmoid-routed MoE layer over x (B, S, d) on the held experts
    only: the router scores every expert, each token's top k are chosen
    on scores + ``bias`` (E,), and of the routed part only the pairs to
    held experts are computed (``grouped_swiglu`` over a buffer of
    ``bound`` rows, 0: every pair, the rows past the held pairs masked);
    pairs to absent experts add nothing.  Plus the shared experts.  With
    a ``bound`` under the pairs, ``over`` (0-d bool, on the device) is set
    when the held pairs outgrow it, and then the output lacks those past
    it.  Returns (out (B, S, d), the sequence-wise balance loss (0-d
    fp32), per-expert pair counts over every expert (E,) fp32, the step's
    counter for the bias update)."""
    m, r = cfg.moe, cfg.router
    b, s_len, d = x.shape
    first, held = cfg.held_experts
    xf = x.reshape(b * s_len, d)
    rows = min(bound, b * s_len * m.top_k) or b * s_len * m.top_k
    with tracing.region("model.moe.route") as rg:
        s, top_e, g = sigmoid_route(p["router"], rg.input(xf), bias,
                                    m.top_k, r.routed_scale)
        aux = seq_balance_loss(s, top_e, b, r.seq_aux_coef)
        g, aux = rg.output(g, aux)
        order, ends = sort_held(top_e, first, held)
    counts = torch.bincount(top_e.reshape(-1),
                            minlength=m.num_experts).float()
    if rows < top_e.numel():
        over.logical_or_(ends[-1] > rows)
        ends = ends.clamp(max=rows)
    with tracing.region("model.moe.shared") as rg:
        shared = rg.output(apply_mlp(p["shared"], rg.input(xf)))
    with tracing.region("model.moe.dispatch") as rg:
        pair = order[:rows]
        tok = pair // m.top_k
        valid = (torch.arange(rows, device=x.device) < ends[-1])[:, None]
        a = rg.output(torch.where(valid, rg.input(xf)[tok], 0))
    with tracing.region("model.moe.experts") as rg:
        y = rg.output(grouped_swiglu(p["experts"], rg.input(a), ends))
    with tracing.region("model.moe.combine") as rg:
        y, g = rg.input(y, g)
        w = g.reshape(-1)[pair].to(x.dtype)
        out = rg.output(xf.new_zeros((b * s_len, d)).index_add(
            0, tok, torch.where(valid, y, 0) * w[:, None]))
    return (out + shared).reshape(b, s_len, d), aux, counts


def update_router_bias(bias: torch.Tensor, counts: torch.Tensor,
                       rate: float) -> None:
    """DeepSeek-V3's aux-loss-free balancing, after an optimizer step:
    b_i += rate · sign(mean_j c_j − c_i) per layer, in place (bias and
    counts (layers, E))."""
    bias.add_(torch.sign(counts.mean(-1, keepdim=True) - counts), alpha=rate)


def routing_counters(counts: torch.Tensor, bias: torch.Tensor,
                     held) -> dict:
    """The routing counters of some steps' per-expert pair counts
    (layers, E) and the bias, read to the host: pairs to held and to
    absent experts, each held expert's pairs summed over the layers, each
    layer's held experts' pairs (layers, held), and the bias's largest
    magnitude."""
    first, n = held
    c = counts.double().cpu()
    mine = c[:, first:first + n]
    return {"held_pairs": float(mine.sum()),
            "absent_pairs": float(c.sum() - mine.sum()),
            "held_counts": mine.sum(0).tolist(),
            "held_by_layer": mine.tolist(),
            "bias_max": float(bias.abs().max())}
