"""The plain reference of the benchmark's configurations, in PyTorch.

fp32 throughout, TF32 off, no kernels, no cache and no batching: one
sequence at a time, attention computed in blocks of queries so that an
8K sequence fits.  It reads a configuration file of ``configs/`` and the
weights the benchmark made (``weights.py``), and imports nothing of the
program.

The model (the paper's section 5.1 hybrid): token embedding; layers in
the repeating ``layer_pattern``, each pre-norm attention and a SwiGLU
MLP with RMSNorm; a final RMSNorm and an untied head.  ``swa`` layers
attend the ``window`` keys up to each query, with RoPE (half-split
rotation); ``moba`` layers take no RoPE and route: each key block's
centroid is the mean of its keys, a query scores the blocks up to its
own by raw q·centroid, future blocks are masked, its own block is
forced, the ``top_k`` best are kept, and it attends their keys causally
with the usual 1/sqrt(d) softmax.

``rnd`` puts the reference in the program's place at a lower precision
(the control): it rounds every tensor the program holds in its compute
dtype (weights at use, matmul outputs, norm outputs, the residual
stream, attention outputs, logits) in the forward, and the gradient
flowing back through each in the backward.  Attention's own arithmetic
stays fp32, as the configuration states.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

NEG = float("-inf")


# ------------------------------------------------------------- precision
def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled e4m3 quantize-dequantize (amax to 448)."""
    amax = x.detach().abs().max().float().clamp(min=1e-30)
    s = 448.0 / amax
    return (x.float() * s).to(torch.float8_e4m3fn).float() / s


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8_e4m3(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to fp8 e4m3 in the forward and the gradient in the backward."""
    return _RoundFP8.apply(x)



@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# ---------------------------------------------------------------- layout
def layers(cfg: dict):
    """(kind, slot name, group index) of every layer, in depth order."""
    pattern = cfg["layer_pattern"]
    return [(kind, f"slot_{i}", g)
            for g in range(cfg["num_layers"] // len(pattern))
            for i, kind in enumerate(pattern)]


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a/b/c": leaf} in sorted-key order."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            out.update(flatten(tree[key], path))
        else:
            out[path] = tree[key]
    return out


# ------------------------------------------------------------ primitives
def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (H, S, d); half-split rotation by angle pos · theta^(-2i/d)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                         dtype=torch.float32) / d)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attend(q, k, v, mask, scale):
    """q (Hkv, G, C, d), k/v (Hkv, n, d), mask (…, C, n) → like q."""
    s = torch.einsum("hgcd,hnd->hgcn", q, k) * scale
    p = torch.softmax(s.masked_fill(~mask, NEG), -1)
    return torch.einsum("hgcn,hnd->hgcd", p, v)


def swa_attention(q, k, v, window: int, chunk: int):
    """q (H, S, d), k/v (Hkv, S, d): keys s with t - window < s <= t."""
    h, n, d = q.shape
    hkv = k.shape[0]
    out = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        lo = max(0, s - window + 1)
        pos = torch.arange(s, e, device=q.device)
        kpos = torch.arange(lo, e, device=q.device)
        rel = pos[:, None] - kpos[None]
        mask = (rel >= 0) & (rel < window)
        qc = q[:, s:e].reshape(hkv, h // hkv, e - s, d)
        out.append(_attend(qc, k[:, lo:e], v[:, lo:e], mask, d ** -0.5
                           ).reshape(h, e - s, d))
    return torch.cat(out, 1)


def moba_select(q, k, block: int, top_k: int, s: int, e: int):
    """Block selection of queries [s, e): (Hkv, G, C, nb) bool."""
    h, n, d = q.shape
    hkv = k.shape[0]
    nb = -(-n // block)
    with torch.no_grad():
        kp = F.pad(k, (0, 0, 0, nb * block - n))
        cnt = (n - torch.arange(nb, device=k.device) * block).clamp(
            max=block)
        cents = kp.reshape(hkv, nb, block, d).sum(2) / cnt[:, None]
        qc = q[:, s:e].reshape(hkv, h // hkv, e - s, d)
        sc = torch.einsum("hgcd,hnd->hgcn", qc, cents)
        own = torch.arange(s, e, device=q.device) // block
        blk = torch.arange(nb, device=q.device)
        sc = sc.masked_fill(blk[None] > own[:, None], NEG)
        sc = sc.masked_fill(blk[None] == own[:, None], float("inf"))
        val, idx = sc.topk(min(top_k, nb), dim=-1)
        idx = torch.where(val > NEG, idx, nb)
        sel = torch.zeros(sc.shape[:-1] + (nb + 1,), dtype=torch.bool,
                          device=q.device)
        return sel.scatter_(-1, idx, True)[..., :nb]


def moba_attention(q, k, v, block: int, top_k: int, chunk: int):
    """q (H, S, d), k/v (Hkv, S, d): MoBA with causal top-k routing."""
    h, n, d = q.shape
    hkv = k.shape[0]
    out = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        sel = moba_select(q, k, block, top_k, s, e)
        kpos = torch.arange(e, device=q.device)
        pos = torch.arange(s, e, device=q.device)
        mask = sel[..., kpos // block] & (pos[:, None] >= kpos[None])
        qc = q[:, s:e].reshape(hkv, h // hkv, e - s, d)
        out.append(_attend(qc, k[:, :e], v[:, :e], mask, d ** -0.5
                           ).reshape(h, e - s, d))
    return torch.cat(out, 1)


# ----------------------------------------------------------------- model
def block_forward(p: dict, x, cfg: dict, kind: str, rnd, chunk: int):
    """One pre-norm layer over x (S, d_model)."""
    n = x.shape[0]
    a = cfg["attention"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    d = cfg["head_dim"] or cfg["d_model"] // h
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(n, device=x.device)

    def mm(y, w):
        return rnd(y @ rnd(w))

    y = rnd(rms_norm(x, p["norm1"], eps))
    q = mm(y, p["attn"]["wq"]).reshape(n, h, d).transpose(0, 1)
    k = mm(y, p["attn"]["wk"]).reshape(n, hkv, d).transpose(0, 1)
    v = mm(y, p["attn"]["wv"]).reshape(n, hkv, d).transpose(0, 1)
    if kind == "moba":
        if a["use_rope"] and a["rope_on_moba"]:
            q, k = rnd(rope(q, pos, a["rope_theta"])), rnd(
                rope(k, pos, a["rope_theta"]))
        m = cfg["moba"]
        o = moba_attention(q, k, v, m["block_size"], m["top_k"], chunk)
    elif kind == "swa":
        if a["use_rope"]:
            q, k = rnd(rope(q, pos, a["rope_theta"])), rnd(
                rope(k, pos, a["rope_theta"]))
        o = swa_attention(q, k, v, a["window"], chunk)
    else:
        raise ValueError(f"the reference has no {kind!r} layer")
    o = rnd(o).transpose(0, 1).reshape(n, h * d)
    x = rnd(x + mm(o, p["attn"]["wo"]))
    y = rnd(rms_norm(x, p["norm2"], eps))
    mlp = p["mlp"]
    hid = rnd(rnd(F.silu(mm(y, mlp["w_gate"]))) * mm(y, mlp["w_up"]))
    return rnd(x + mm(hid, mlp["w_down"]))


def _group(tree: dict, g: int) -> dict:
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def hidden(params: dict, tokens, cfg: dict, rnd=identity,
           chunk: int = 1024, remat: bool = False):
    """Final-norm hidden states (S, d_model) of one sequence."""
    x = rnd(params["embed"][tokens.long()])
    for kind, slot, g in layers(cfg):
        p = _group(params["blocks"][slot], g)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block_forward, p, x, cfg, kind, rnd, chunk,
                use_reentrant=False)
        else:
            x = block_forward(p, x, cfg, kind, rnd, chunk)
    return rnd(rms_norm(x, params["final_norm"], cfg["rms_norm_eps"]))


def logits_at(params: dict, tokens, positions, cfg: dict, rnd=identity,
              chunk: int = 1024):
    """fp32 logits (len(positions), V) of one sequence at ``positions``."""
    with torch.no_grad():
        x = hidden(params, tokens, cfg, rnd, chunk)[positions]
        return rnd(x @ rnd(params["lm_head"]))


def row_loss(params: dict, tokens, cfg: dict, rnd=identity,
             chunk: int = 1024):
    """Mean next-token cross entropy of one row of S + 1 tokens."""
    x = hidden(params, tokens[:-1], cfg, rnd, chunk, remat=True)
    lg = rnd(x @ rnd(params["lm_head"]))
    tgt = tokens[1:].long()
    return (torch.logsumexp(lg, -1) - lg.gather(-1, tgt[:, None])[:, 0]
            ).mean()


# -------------------------------------------------------------- training
def _lr(tc: dict, step: int) -> float:
    """Linear warmup, then a cosine from the peak to a tenth of it."""
    peak, warm = tc["learning_rate"], tc["warmup_steps"]
    if step < warm:
        return peak * (step + 1) / max(warm, 1)
    t = min(max((step - warm) / max(tc["total_steps"] - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.45 * (1 + math.cos(math.pi * t)))


def _decays(path: str) -> bool:
    """Weight decay on matrices, the embedding and the head; none on the
    RMSNorm scales."""
    return not path.split("/")[-1].startswith("norm") \
        and path != "final_norm"


def train_steps(params0: Dict[str, torch.Tensor], batches: Sequence,
                cfg: dict, device, rnd=identity, chunk: int = 1024
                ) -> dict:
    """The first ``len(batches)`` AdamW steps from ``params0`` (flat
    {path: leaf}, any device), one (rows, S + 1) token batch a step, the
    loss the mean over rows.  Returns each step's loss and unclipped
    global gradient norm, each leaf's norm of the first (clipped)
    gradient and of its change over all the steps."""
    tc = cfg["train"]
    params = {k: v.to(device, torch.float32).clone().requires_grad_()
              for k, v in params0.items()}
    tree = _unflatten(params)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"loss": [], "grad_norm": []}
    with exact_fp32():
        for step, batch in enumerate(batches):
            rows = batch.shape[0]
            loss = 0.0
            for r in range(rows):
                lr_ = row_loss(tree, batch[r].to(device), cfg, rnd, chunk)
                (lr_ / rows).backward()
                loss += float(lr_.detach()) / rows
            grads = {k: p.grad for k, p in params.items()}
            gn = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = min(1.0, tc["grad_clip"] / max(float(gn), 1e-9))
            out["loss"].append(loss)
            out["grad_norm"].append(float(gn))
            lr = _lr(tc, step)
            b1, b2 = tc["beta1"], tc["beta2"]
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            with torch.no_grad():
                if step == 0:
                    out["first_grad"] = {k: float(g.norm()) * scale
                                         for k, g in grads.items()}
                for k, p in params.items():
                    g = grads[k] * scale
                    mu[k].mul_(b1).add_(g, alpha=1 - b1)
                    nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
                    upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2)
                                          + tc["eps"])
                    if _decays(k):
                        upd = upd + tc["weight_decay"] * p
                    p.sub_(lr * upd)
                    p.grad = None
    with torch.no_grad():
        out["change"] = {k: float((p - params0[k].to(device)).norm())
                         for k, p in params.items()}
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


# --------------------------------------------------------------- serving
def served_gaps(params: dict, cfg: dict, seqs: List, device,
                rnd: Optional[Callable] = None, chunk: int = 1024):
    """For each (prompt, served tokens): the widest gap by which a served
    token's fp32 logit lies below the best logit at its position.  With
    ``rnd``, the served tokens are instead those that the reference at
    that precision puts first at each position of the same sequence
    (the control)."""
    gaps = []
    with exact_fp32():
        for prompt, served in seqs:
            toks = torch.as_tensor(list(prompt) + list(served[:-1]),
                                   device=device)
            pos = torch.arange(len(prompt) - 1, len(toks), device=device)
            ref = logits_at(params, toks, pos, cfg, identity, chunk)
            if rnd is None:
                chosen = torch.as_tensor(list(served), device=device)
            else:
                chosen = logits_at(params, toks, pos, cfg, rnd,
                                   chunk).argmax(-1)
            best = ref.max(-1).values
            got = ref.gather(-1, chosen.long()[:, None])[:, 0]
            gaps.append(float((best - got).max()))
    return gaps
