"""Mamba-2 (SSD, state-space duality) block, chunked-scan formulation.

Dao & Gu 2024 (arXiv:2405.21060), as the reference writes it: per-head
scalar decay ``a_t = exp(Δ_t · A)``, rank-1 state updates ``h_t = a_t
h_{t-1} + Δ_t B_t x_tᵀ`` and outputs ``y_t = C_tᵀ h_t + D x_t``, computed
chunk-parallel as batched products, with a loop over chunks only for the
small inter-chunk carry.  Three branches: one-shot (no cache), prefill
into a cache (which rebuilds the final recurrent state), and the
recurrent single-token decode step.

No kernel: the reference runs the scan outside Pallas, and here it is
``torch`` einsums.  Caches are updated in place; their ``len`` is a host
int, as the port's dense attention caches keep it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm, wcast


def ssm_dims(cfg: ModelConfig):
    """(d_inner, heads, head_dim, state size) of ``cfg``'s Mamba-2."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.num_heads or d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.state_size


def mamba2_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of one Mamba-2 block's params (``init_mamba2``);
    ``in_proj``'s columns are [z (d_inner), xBC (conv_dim), dt (heads)]."""
    d = cfg.d_model
    d_inner, nh, _, ns = ssm_dims(cfg)
    return {"in_proj": (d, 2 * d_inner + 2 * ns + nh),
            "conv_w": (cfg.ssm.conv_width, d_inner + 2 * ns),
            "a_log": (nh,), "dt_bias": (nh,), "d_skip": (nh,),
            "norm_scale": (d_inner,), "out_proj": (d_inner, d)}


def init_mamba2(gen: torch.Generator, cfg: ModelConfig,
                lead: Tuple[int, ...] = ()) -> dict:
    """The reference's leaves and scales (random draws differ):
    projections ~ N(0, 1/fan_in), conv ~ N(0, 0.01), ``a_log`` =
    log(linspace(1, 16, heads)), ``dt_bias`` 0, ``d_skip`` and the norm
    scale 1.  ``lead`` prepends the layer-group axis."""
    shapes = mamba2_shapes(cfg)
    dev = gen.device

    def randn(name, scale):
        return torch.randn(lead + shapes[name], generator=gen,
                           device=dev).mul_(scale)

    def full(name, row):
        return row.to(dev).expand(lead + shapes[name]).contiguous()

    nh = shapes["a_log"][0]
    return {
        "in_proj": randn("in_proj", cfg.d_model ** -0.5),
        "conv_w": randn("conv_w", 0.1),
        "a_log": full("a_log", torch.log(torch.linspace(1.0, 16.0, nh))),
        "dt_bias": full("dt_bias", torch.zeros(nh)),
        "d_skip": full("d_skip", torch.ones(nh)),
        "norm_scale": full("norm_scale",
                           torch.ones(shapes["norm_scale"])),
        "out_proj": randn("out_proj", shapes["out_proj"][0] ** -0.5),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv + SiLU.  x (B, T, C), w (W, C); ``state``
    (B, W-1, C) holds the raw inputs before x (zeros when None).
    Returns (out, the last W-1 raw inputs)."""
    width = w.shape[0]
    if state is not None:
        x_ext = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, width - 1, 0))
    t = x.shape[1]
    out = sum(x_ext[:, i:i + t] * w[i] for i in range(width))
    new_state = x_ext[:, x_ext.shape[1] - (width - 1):] if width > 1 \
        else state
    return F.silu(out), new_state


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int) -> torch.Tensor:
    """SSD chunked scan.  x (B, T, H, P); dt (B, T, H) after softplus;
    b, c (B, T, N); T a multiple of ``chunk``.  Returns y (B, T, H, P)."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    nc = t // chunk
    a = -torch.exp(a_log)                                 # (H,) negative
    la = dt * a[None, None, :]                            # log decay

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    lac = la.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(lac, dim=2)                        # (B, nc, Q, H)
    # intra-chunk: S_ij = (C_i·B_j) exp(cum_i - cum_j) dt_j for i >= j;
    # masked before the exp, so neither pass meets inf · 0
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)          # (B, nc, Q, Q)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[..., None]
    s = (cb[..., None]
         * torch.exp(torch.where(causal, decay,
                                 decay.new_full((), float("-inf"))))
         * dtc[:, :, None, :, :])                          # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", s, xc)

    # chunk summary state: Σ_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    tail = cum[:, :, -1:, :] - cum
    contrib = torch.einsum("bcjh,bcjn,bcjhp->bchnp",
                           torch.exp(tail) * dtc, bc, xc)  # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[:, :, -1])                 # (B, nc, H)

    hstate = x.new_zeros((bsz, h, n, p), dtype=torch.float32)
    pre = []                                               # pre-states
    for ci in range(nc):
        pre.append(hstate)
        hstate = (hstate * chunk_decay[:, ci, :, None, None].float()
                  + contrib[:, ci].float())
    hpre = torch.stack(pre, dim=1)                         # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp",
                           cc, hpre.to(cc.dtype), torch.exp(cum))
    y = y_intra + y_inter + xc * d_skip[None, None, None, :, None]
    return y.reshape(bsz, t, h, p)


def apply_mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, T, d_model) -> (y, cache).  Without a cache: the chunked
    scan.  With one and T > 1: a prefill, which runs the chunked scan
    (T padded to the chunk) and rebuilds the final state for decode.
    With one and T == 1: the recurrent step on the cached (H, N, P)
    state.  A cache's ``conv`` and ``ssm`` are written in place; the
    returned dict's host-int ``len`` counts the tokens."""
    d_inner, nh, hd, ns = ssm_dims(cfg)
    bsz, t, _ = x.shape
    dt_ = x.dtype

    proj = x @ wcast(p["in_proj"], dt_)
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * ns, nh],
                                 dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = causal_conv(xbc, wcast(p["conv_w"], dt_), conv_state)
    xs, b, c = torch.split(xbc, [d_inner, ns, ns], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])
    xh = xs.reshape(bsz, t, nh, hd)

    if cache is None or t > 1:
        chunk = min(cfg.ssm.chunk_size, t)
        pad = (-t) % chunk
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            b = F.pad(b, (0, 0, 0, pad))
            c = F.pad(c, (0, 0, 0, pad))
        y = ssd_chunked(xh.float(), dt, p["a_log"], b.float(), c.float(),
                        p["d_skip"], chunk)[:, :t]
        new_cache = None
        if cache is not None:
            # the final recurrent state, for the decode steps after this
            la = dt[:, :t] * (-torch.exp(p["a_log"]))[None, None]
            rev = torch.flip(torch.cumsum(torch.flip(la, [1]), 1), [1])
            w = torch.exp(rev - la)
            hstate = torch.einsum("bth,btn,bthp->bhnp", w * dt[:, :t],
                                  b[:, :t].float(), xh[:, :t].float())
            new_cache = _written(cache, new_conv, hstate, t)
    else:
        a = -torch.exp(p["a_log"])                        # (H,)
        la = (dt[:, 0] * a[None]).float()                 # (B, H)
        contrib = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0],
                               b[:, 0].float(), xh[:, 0].float())
        hstate = cache["ssm"] * torch.exp(la)[..., None, None] + contrib
        y = (torch.einsum("bn,bhnp->bhp", c[:, 0].float(), hstate)
             + xh[:, 0].float() * p["d_skip"][None, :, None])[:, None]
        new_cache = _written(cache, new_conv, hstate, 1)

    y = y.reshape(bsz, t, d_inner).to(dt_)
    # gated RMSNorm (mamba2 style): norm(y * silu(z))
    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg.rms_norm_eps)
    return y @ wcast(p["out_proj"], dt_), new_cache


def _written(cache: dict, conv: torch.Tensor, ssm: torch.Tensor,
             n: int) -> dict:
    cache["conv"].copy_(conv)
    cache["ssm"].copy_(ssm)
    return dict(cache, len=cache["len"] + n)


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device="cuda", groups: int = 0) -> dict:
    """Zero state: ``conv`` (B, W-1, conv_dim) in ``dtype``, ``ssm`` (B,
    H, N, P) fp32, ``len`` 0 (a host int).  ``groups > 0`` prepends the
    layer-group axis to both tensors."""
    d_inner, nh, hd, ns = ssm_dims(cfg)
    lead = (groups,) if groups else ()
    return {"conv": torch.zeros(lead + (batch, cfg.ssm.conv_width - 1,
                                        d_inner + 2 * ns),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(lead + (batch, nh, ns, hd),
                               dtype=torch.float32, device=device),
            "len": 0}
