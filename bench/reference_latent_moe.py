"""The plain reference of the latent-attention MoE configuration
(``configs/moonlight-16b-a3b.json``: DeepSeek-V3's block,
arXiv:2405.04434 §2.1 and arXiv:2412.19437 §2.1), in PyTorch.

fp32 throughout, TF32 off, no kernels, no cache and no batching: one
sequence at a time, attention computed in blocks of queries so that an
8K sequence fits.  It reads the configuration file and the weights
:func:`make_params` makes, and imports nothing of the program; it uses
``reference.py``'s helpers (precision, RoPE, norms, MoBA's block
selection, AdamW's schedule).

The model, per token x (RMSNorm eps ``rms_norm_eps``, SwiGLU with silu):

- latent attention, ``num_attention_heads`` heads: q = x·W_q, each head
  ``qk_nope_head_dim`` + ``qk_rope_head_dim`` wide; [c, k_pe] = x·W_kv_a
  with c the ``kv_lora_rank`` latent; c = RMSNorm(c); [k_nope, v] =
  c·W_kv_b per head; RoPE (θ ``rope_theta``, half-split pairs) on q_pe
  and on k_pe, one vector shared by every head; q = [q_nope, q_pe], k =
  [k_nope, k_pe], softmax scale (q/k width)^-½, o (``v_head_dim`` a
  head) through W_o;
- MoBA on it: a block's centroid is the mean of its keys (the whole q/k
  width, after RoPE); a query scores the blocks up to its own by
  q·centroid, its own is forced, the ``top_k`` best are kept, and it
  attends their keys causally;
- the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; every later one routed experts: s =
  sigmoid(x·W_r) over the router's ``published.n_routed_experts``
  outputs (fp32), the top ``num_experts_per_tok`` chosen on s + b (b a
  per-expert bias, no parameter), g_i = ``routed_scaling_factor`` · s_i
  / Σ_chosen s, output = shared(x) + Σ over chosen held experts g_i ·
  FFN_i(x), the shared part one SwiGLU of ``n_shared_experts`` ·
  ``moe_intermediate_size``;
- per row of T tokens and MoE layer, the sequence-wise balance loss α ·
  Σ_i f_i · P_i with f_i = E/(k·T) · the tokens that chose i and P_i the
  mean over the row of s_i / Σ_j s_j, averaged over the rows and added
  to the loss (α ``seq_aux_alpha``);
- after each AdamW step, b_i += γ · sign(mean_j c_j − c_i) with c the
  step's pairs per expert over every expert (γ ``bias_update_gamma``).

Departures from the published model, each stated in the configuration
file: one chip's share (the ``n_routed_experts`` held experts from
``held_first_expert``, the routed part of absent experts left out, a
``vocab_size`` slice of the vocabulary); RoPE on half-split pairs where
the published code interleaves them (a permutation of W_q's and W_kv_a's
RoPE columns); MoBA in place of full attention; n_group = topk_group = 1
make group-limited routing the identity and are not coded.

``rnd`` rounds every tensor the program holds in its compute dtype (the
control), as ``reference.py``'s does; the router's scores and the
attention's arithmetic stay fp32, as in the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from bench import reference as R
from bench import weights


def smoke_config(cfg: dict, dtype: str = "float32", held: int = 8,
                 held_first: int = 0) -> dict:
    """The configuration file ``cfg`` at a width and depth a CPU test
    holds, its router's 64 outputs and 6 a token kept: 3 layers (one
    dense), d 64, 4 heads of q/k 24 + 8 and v 16, latent 16, expert width
    32, ``held`` experts held from ``held_first``, 256 ids, MoBA block 16
    / top_k 2."""
    out = dict(cfg, num_hidden_layers=3, hidden_size=64,
               num_attention_heads=4, num_key_value_heads=4,
               qk_nope_head_dim=24, qk_rope_head_dim=8, v_head_dim=16,
               kv_lora_rank=16, intermediate_size=96,
               moe_intermediate_size=32, n_routed_experts=held,
               held_first_expert=held_first, vocab_size=256,
               max_position_embeddings=256, dtype=dtype)
    out["moba"] = dict(cfg["moba"], block_size=16, top_k=2)
    return out


# ------------------------------------------------------------ the model
def moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def param_shapes(cfg: dict) -> Dict:
    """Leaf shapes, in the program's tree: ``layers/layer_ii`` blocks of
    ``attn`` (wq, wkv_a, kv_norm_scale, wkv_b, wo), ``norm1``, ``norm2``
    and ``mlp`` or ``moe`` (router, the held ``experts`` stacked,
    ``shared``)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    f, held = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    fs = f * cfg["n_shared_experts"]

    def swiglu(width, lead=()):
        return {"w_gate": lead + (d, width), "w_up": lead + (d, width),
                "w_down": lead + (width, d)}

    tree = {"embed": (cfg["vocab_size"], d), "final_norm": (d,),
            "lm_head": (d, cfg["vocab_size"]), "layers": {}}
    for i in range(cfg["num_hidden_layers"]):
        ffn = ({"mlp": swiglu(cfg["intermediate_size"])}
               if i < cfg["first_k_dense_replace"] else
               {"moe": {"router": (d, cfg["published"]["n_routed_experts"]),
                        "experts": swiglu(f, (held,)),
                        "shared": swiglu(fs)}})
        tree["layers"][f"layer_{i:02d}"] = {
            "norm1": (d,), "norm2": (d,),
            "attn": {"wq": (d, h * qk),
                     "wkv_a": (d, r + cfg["qk_rope_head_dim"]),
                     "kv_norm_scale": (r,),
                     "wkv_b": (r, h * (cfg["qk_nope_head_dim"] + dv)),
                     "wo": (h * dv, d)},
            **ffn}
    return tree


def make_params(cfg: dict, seed: int, device) -> Dict:
    """The parameters of ``cfg`` for ``seed`` on ``device`` (fp32), drawn
    leaf by leaf in sorted path order from ``weights.generator``'s stream
    0: the embedding N(0, embed_std²), matrices N(0, 1/fan_in) (an expert
    stack's fan-in is its middle dim), norm scales 1."""
    g = weights.generator(seed, device)
    flat = R.flatten(param_shapes(cfg))
    out = {}
    for path, shape in flat.items():
        if len(shape) == 1:
            out[path] = torch.ones(shape, device=device)
            continue
        std = (cfg["init"]["embed_std"] if path == "embed"
               else shape[-2] ** -0.5)
        out[path] = torch.randn(shape, generator=g, device=device).mul_(std)
    return R._unflatten(out)


def mla_attention(p: dict, y, cfg: dict, rnd, chunk: int):
    """Latent attention with MoBA over one sequence y (S, d) → (S, d)."""
    n = y.shape[0]
    h, eps = cfg["num_attention_heads"], cfg["rms_norm_eps"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r, theta = cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["rope_theta"]
    pos = torch.arange(n, device=y.device)

    def mm(a, w):
        return rnd(a @ rnd(w))

    q = mm(y, p["wq"]).reshape(n, h, dn + dr).transpose(0, 1)
    q = torch.cat([q[..., :dn], rnd(R.rope(q[..., dn:], pos, theta))], -1)
    ckv = mm(y, p["wkv_a"])
    c = rnd(R.rms_norm(ckv[:, :r], p["kv_norm_scale"], eps))
    k_pe = rnd(R.rope(ckv[None, :, r:], pos, theta))          # (1, S, dr)
    kv = mm(c, p["wkv_b"]).reshape(n, h, dn + dv).transpose(0, 1)
    k = torch.cat([kv[..., :dn], k_pe.expand(h, n, dr)], -1)
    v = kv[..., dn:]
    m = cfg["moba"]
    scale = (dn + dr) ** -0.5
    out = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        sel = R.moba_select(q, k, m["block_size"], m["top_k"], s, e)
        kpos = torch.arange(e, device=y.device)
        qpos = torch.arange(s, e, device=y.device)
        mask = sel[..., kpos // m["block_size"]] & (qpos[:, None]
                                                   >= kpos[None])
        out.append(R._attend(q[:, None, s:e], k[:, :e], v[:, :e], mask,
                             scale)[:, 0])
    o = rnd(torch.cat(out, 1)).transpose(0, 1).reshape(n, h * dv)
    return mm(o, p["wo"])


def route(router, y, bias, cfg: dict):
    """fp32 sigmoid scores s (T, E), the chosen experts (T, k) on s +
    bias (descending, ties to the lower id) and their weights (T, k)."""
    s = torch.sigmoid(y @ router)
    k = cfg["num_experts_per_tok"]
    idx = torch.sort((s + bias).detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    top = s.gather(-1, idx)
    return s, idx, top * (cfg["routed_scaling_factor"]
                          / top.sum(-1, keepdim=True))


def held_moe(p: dict, y, bias, cfg: dict, rnd):
    """One MoE layer over one sequence y (T, d): (output, balance loss,
    pairs per expert over every expert (E,))."""
    mm = lambda a, w: rnd(a @ rnd(w))  # noqa: E731

    def swiglu(w, a):
        return mm(rnd(rnd(F.silu(mm(a, w["w_gate"]))) * mm(a, w["w_up"])),
                  w["w_down"])

    t = y.shape[0]
    s, idx, g = route(p["router"], y, bias, cfg)
    e_all, k = s.shape[1], idx.shape[1]
    counts = torch.bincount(idx.reshape(-1), minlength=e_all).float()
    p_mean = (s / s.sum(-1, keepdim=True)).mean(0)
    aux = cfg["seq_aux_alpha"] * (counts * (e_all / (k * t)) * p_mean).sum()
    first = cfg["held_first_expert"]
    routed = torch.zeros_like(y)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == first + j, as_tuple=True)
        if len(tok):
            w = {name: leaf[j] for name, leaf in p["experts"].items()}
            routed = routed.index_add(
                0, tok, rnd(rnd(g[tok, slot])[:, None] * swiglu(w, y[tok])))
    out = rnd(rnd(routed) + swiglu(p["shared"], y))
    return out, aux, counts


def block(p: dict, x, bias, cfg: dict, rnd, chunk: int):
    """One pre-norm layer over x (S, d): (x, balance loss, counts), the
    last two zero for a dense layer."""
    eps = cfg["rms_norm_eps"]
    y = rnd(R.rms_norm(x, p["norm1"], eps))
    x = rnd(x + mla_attention(p["attn"], y, cfg, rnd, chunk))
    y = rnd(R.rms_norm(x, p["norm2"], eps))
    if "mlp" in p:
        w = p["mlp"]
        h = rnd(rnd(F.silu(rnd(y @ rnd(w["w_gate"]))))
                * rnd(y @ rnd(w["w_up"])))
        zero = x.new_zeros(())
        return rnd(x + rnd(h @ rnd(w["w_down"]))), zero, x.new_zeros(
            cfg["published"]["n_routed_experts"])
    out, aux, counts = held_moe(p["moe"], y, bias, cfg, rnd)
    return rnd(x + out), aux, counts


def row_forward(params: dict, tokens, cfg: dict, bias, rnd=R.identity,
                chunk: int = 1024, remat: bool = False):
    """Final-norm hidden states (S, d) of one sequence, its balance loss
    summed over layers, and the pairs each expert got in each MoE layer
    (layers, E).  ``bias`` (MoE layers, E)."""
    x = rnd(params["embed"][tokens.long()])
    aux, counts = x.new_zeros(()), []
    dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        p = params["layers"][f"layer_{i:02d}"]
        b = bias[max(i - dense, 0)]
        if remat:
            x, a, c = torch.utils.checkpoint.checkpoint(
                block, p, x, b, cfg, rnd, chunk, use_reentrant=False)
        else:
            x, a, c = block(p, x, b, cfg, rnd, chunk)
        aux = aux + a
        if i >= dense:
            counts.append(c)
    x = rnd(R.rms_norm(x, params["final_norm"], cfg["rms_norm_eps"]))
    return x, aux, torch.stack(counts)


def logits_at(params: dict, tokens, cfg: dict, bias=None, rnd=R.identity,
              chunk: int = 1024):
    """fp32 logits (S, V) of one sequence."""
    with torch.no_grad():
        bias = _zero_bias(cfg, tokens.device) if bias is None else bias
        x, _, _ = row_forward(params, tokens, cfg, bias, rnd, chunk)
        return rnd(x @ rnd(params["lm_head"]))


def row_loss(params: dict, tokens, cfg: dict, bias, rnd=R.identity,
             chunk: int = 1024):
    """(mean next-token cross entropy + the balance loss, the pairs per
    expert (layers, E)) of one row of S + 1 tokens."""
    x, aux, counts = row_forward(params, tokens[:-1], cfg, bias, rnd, chunk,
                                 remat=True)
    lg = rnd(x @ rnd(params["lm_head"]))
    tgt = tokens[1:].long()
    ce = (torch.logsumexp(lg, -1) - lg.gather(-1, tgt[:, None])[:, 0]).mean()
    return ce + aux, counts


def _zero_bias(cfg: dict, device):
    return torch.zeros((moe_layers(cfg),
                        cfg["published"]["n_routed_experts"]), device=device)


# -------------------------------------------------------------- training
def _decays(path: str) -> bool:
    """Weight decay on matrices, the embedding and the head; none on the
    RMSNorm scales (the latent's included)."""
    last = path.split("/")[-1]
    return not (last.startswith("norm") or last.endswith("norm_scale")
                or last == "final_norm")


def train_steps(params0: Dict[str, torch.Tensor], batches: Sequence,
                cfg: dict, device, rnd=R.identity, chunk: int = 1024
                ) -> dict:
    """The first ``len(batches)`` AdamW steps from ``params0`` (flat
    {path: leaf}, any device) with the routing bias from 0, one (rows, S
    + 1) token batch a step, the loss the mean over rows; after each
    step the bias moves by the step's pairs per expert.  Returns each
    step's loss, unclipped global gradient norm and pairs per expert
    (MoE layers, E), each leaf's norm of the first (clipped) gradient and
    of its change over all the steps, and the bias at the end."""
    tc = cfg["train"]
    params = {k: v.to(device, torch.float32).clone().requires_grad_()
              for k, v in params0.items()}
    tree = R._unflatten(params)
    bias = _zero_bias(cfg, device)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"loss": [], "grad_norm": [], "counts": []}
    with R.exact_fp32():
        for step, batch in enumerate(batches):
            rows = batch.shape[0]
            loss, counts = 0.0, torch.zeros_like(bias)
            for r in range(rows):
                lr_, c = row_loss(tree, batch[r].to(device), cfg, bias, rnd,
                                  chunk)
                (lr_ / rows).backward()
                loss += float(lr_.detach()) / rows
                counts += c
            grads = {k: p.grad for k, p in params.items()}
            gn = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = min(1.0, tc["grad_clip"] / max(float(gn), 1e-9))
            out["loss"].append(loss)
            out["grad_norm"].append(float(gn))
            lr = R._lr(tc, step)
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
                out["counts"].append(counts.cpu())
                bias += cfg["bias_update_gamma"] * torch.sign(
                    counts.mean(-1, keepdim=True) - counts)
    with torch.no_grad():
        out["change"] = {k: float((p - params0[k].to(device)).norm())
                         for k, p in params.items()}
    out["bias"] = bias
    return out
