"""Mixture-of-Experts MLP with GShard-style capacity-based dispatch.

The reference's formulation, step for step: a fp32 router, top-k experts
per token in ``lax.top_k``'s order, renormalised top-k weights, each
(token, slot) pair's position in its expert's capacity buffer from a
cumsum over the pairs in token-major order, pairs past the capacity
dropped into a spare expert row that is discarded, every expert's SwiGLU
as one batched product over the (E, capacity, d) buffer, the gather
back, shared experts, and the Switch Transformer load-balance loss.

Every shape is known on the host and nothing reads a device value back,
so a decode step enqueues without a sync.  No kernel: the reference runs
all of this outside Pallas, and here it is ``torch`` products and
indexing.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
