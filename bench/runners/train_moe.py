"""The training runner of a latent-attention MoE configuration
(``configs/moonlight-16b-a3b.json``): ``repro_torch.launch.steps.
make_train_step`` on the program's ``LatentMoEConfig``, with its AdamW
state and routing state, on seeded token rows.

As ``runners/train.py``: set-up builds the step, the model, the
optimizer and routing state once, drives them through the traffic's
``checked_steps`` first steps (each on rows of its own) and hands them to
the window, which keeps stepping; a step ends in a host read of its
loss.  ``correct`` compares the checked steps' loss and gradient norm,
each leaf's first gradient and change, the pairs each expert got and
the routing bias they leave, with the plain reference
(``reference_latent_moe.py``), which follows the same steps from the
same weights and rows after the window, routing on its own fp32 scores
and moving its own bias (``expert_count_gap``: the pairs by which the
per-(layer, expert) counts differ, as a share of the step's pairs;
``router_bias_gap``: the share of the bias's entries that differ by half
an update or more; ``first_grad_matrix_gap``: the first gradient by the
worst weight matrix, the routers and norm scales left out; they stay in
``first_grad_leaf_gap``, which is reported and not judged).  Besides
``faults.TRAIN``, two faults of the bias update are planted here (``FAULTS``): ``bias_frozen``, a step that leaves the bias
as it was, and ``bias_sign``, one that moves it the wrong way.

Set-up ends in a full collection and freezes its heap (``gc.freeze``),
so the collector's full passes in the window skip the set-up's objects,
as a training loop that freezes its long-lived state does.

Besides, the window's per-expert pair counts (the step's
``expert_counts``, summed on the device) and, at its end, the program's
routing counters: pairs to held and to absent experts, each held
expert's pairs, the bias's largest magnitude, and the steps that took
their gradients again because a layer's held pairs outgrew their buffer
(``retaken_steps``).
"""
from __future__ import annotations

import gc
import time

import torch

from bench import checks, faults, reference, trace
from bench import reference_latent_moe as RM
from bench import weights
from bench.runners import program

FAULTS = faults.TRAIN + ("bias_frozen", "bias_sign")


def model_config(cfg: dict):
    """``repro_torch.configs.base.LatentMoEConfig`` of a configuration
    file (the published keys, the held share and the assumed sizes)."""
    from repro_torch.configs import base

    if (cfg["n_group"], cfg["topk_group"], cfg["moe_layer_freq"]) != \
            (1, 1, 1) or cfg["q_lora_rank"] is not None or \
            cfg["scoring_func"] != "sigmoid" or not cfg["norm_topk_prob"]:
        raise ValueError("the program runs ungrouped sigmoid routing with "
                         "renormalised weights, an MoE layer after every "
                         "dense one and no query latent")
    m = cfg["moba"]
    return base.LatentMoEConfig(
        name=cfg["name"], family="latent_moe",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        max_seq_len=cfg["max_position_embeddings"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rms_norm_eps=cfg["rms_norm_eps"],
        attention=base.AttentionConfig(
            kind="moba", rope_theta=float(cfg["rope_theta"]),
            moba=base.MoBAConfig(block_size=m["block_size"],
                                 top_k=m["top_k"], causal=m["causal"])),
        layer_pattern=("moba",),
        moe=base.MoEConfig(num_experts=cfg["published"]["n_routed_experts"],
                           top_k=cfg["num_experts_per_tok"],
                           num_shared_experts=cfg["n_shared_experts"],
                           expert_d_ff=cfg["moe_intermediate_size"]),
        mla=base.MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                           qk_nope_head_dim=cfg["qk_nope_head_dim"],
                           qk_rope_head_dim=cfg["qk_rope_head_dim"],
                           v_head_dim=cfg["v_head_dim"]),
        router=base.RouterConfig(
            routed_scale=cfg["routed_scaling_factor"],
            seq_aux_coef=cfg["seq_aux_alpha"],
            bias_rate=cfg["bias_update_gamma"],
            held_first=cfg["held_first_expert"],
            held_count=cfg["n_routed_experts"]),
        first_k_dense=cfg["first_k_dense_replace"], dtype=cfg["dtype"],
        param_dtype=cfg["param_dtype"])


def _bias_fault(step, fault, bias: torch.Tensor):
    """``step`` with a fault of the bias update planted: the update undone
    (``bias_frozen``) or applied with its sign turned (``bias_sign``)."""
    def planted(params, opt, batch):
        keep = bias.clone()
        out = step(params, opt, batch)
        if fault == "bias_frozen":
            bias.copy_(keep)
        else:
            bias.copy_(2 * keep - bias)
        return out
    return planted


def bias_gap(got: torch.Tensor, ref: torch.Tensor, rate: float) -> float:
    """The share of the bias's entries that lie half an update (``rate``)
    or more from the reference's."""
    off = (got.double().cpu() - ref.double().cpu()).abs() >= rate / 2
    return float(off.double().mean())


def count_gap(got, ref) -> float:
    """By the worst checked step, the pairs by which the program's
    per-(layer, expert) counts differ from the reference's, as a share
    of the step's pairs."""
    return max(float((a.double().cpu() - b.double().cpu()).abs().sum()
                     / b.double().sum()) for a, b in zip(got, ref))


def matrices(names) -> set:
    """The weight matrices among the leaves ``names``, the routers left
    out: a router's first gradient follows which experts the near-tied
    tokens pick, and an RMSNorm scale's is a sum over the microbatch's
    tokens of terms that cancel, so either moves by more than rounding
    between two sound runs."""
    return {k for k in names if not k.endswith("/router")
            and "norm" not in k.split("/")[-1]}


def numbers(got: dict, ref: dict, cfg: dict) -> dict:
    """The numbers ``correct`` compares: ``checks.train_numbers``'s,
    ``first_grad_matrix_gap`` (its first-gradient measure over
    :func:`matrices`), ``router_bias_gap`` and ``expert_count_gap``."""
    out = checks.train_numbers(got, ref)
    out["first_grad_matrix_gap"] = checks.leaf_gap(
        got["first_grad"], ref["first_grad"], matrices(ref["first_grad"]))
    out["router_bias_gap"] = bias_gap(got["bias"], ref["bias"],
                                      cfg["bias_update_gamma"])
    out["expert_count_gap"] = count_gap(got["counts"], ref["counts"])
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(r) -> dict:
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer
    from repro_torch.optim import adamw

    cfg, tr, dev = r.config, r.traffic, r.device
    rows, seq, checked = tr["rows"], tr["seq_len"], tr["checked_steps"]
    mcfg = model_config(cfg)
    params = RM.make_params(cfg, r.seed, dev)
    p0 = {k: v.detach().to("cpu", copy=True)
          for k, v in reference.flatten(params).items()}
    batches = weights.train_batches(cfg, r.seed, tr["batches"], rows, seq,
                                    dev)
    opt = adamw.adamw_init(params)
    state = transformer.init_router_state(mcfg, dev)
    step = steps.make_train_step(
        mcfg, program.train_config(cfg, rows, seq, tr["microbatch"]),
        backend=tr["backend"], remat=tr["remat"], state=state)
    if r.fault in ("bias_frozen", "bias_sign"):
        step = _bias_fault(step, r.fault, state["router_bias"])
    else:
        step = faults.train_step(step, r.fault, rows, seq)

    got = {"loss": [], "grad_norm": [], "counts": []}
    b1 = cfg["train"]["beta1"]
    for i in range(checked):
        params, opt, out = step(params, opt, {"tokens": batches[i]})
        got["loss"].append(float(out["loss"]))
        got["grad_norm"].append(float(out["grad_norm"]))
        got["counts"].append(out["expert_counts"].cpu())
        if i == 0:
            got["first_grad"] = {
                k: float(m.norm()) / (1 - b1)
                for k, m in reference.flatten(opt.mu).items()}
    with torch.no_grad():
        got["change"] = {k: float((p - p0[k].to(dev)).norm())
                         for k, p in reference.flatten(params).items()}
    got["bias"] = state["router_bias"].to("cpu", copy=True)
    _sync(dev)
    gc.collect()
    gc.freeze()
    rec = {"setup_s": time.perf_counter() - r.t_start}
    peak_setup = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # the window: steps started before its end, each to its loss
    counts = torch.zeros_like(state["expert_counts"])
    n, prof_steps, prof, retaken = 0, tr["profile_steps"], None, 0
    t0 = time.perf_counter()
    while r.seconds > 0:      # no window: the first steps' readings only
        batch = {"tokens": batches[checked + n % (len(batches) - checked)]}
        if r.trace and n == 1:
            with trace.profiled() as prof:
                with trace.span("window"):
                    for _ in range(prof_steps):
                        params, opt, out = step(params, opt, batch)
                        float(out["loss"])
                        counts += out["expert_counts"]
                        retaken += out["retaken"]
                        n += 1
        else:
            params, opt, out = step(params, opt, batch)
            float(out["loss"])
            counts += out["expert_counts"]
            retaken += out["retaken"]
            n += 1
        if time.perf_counter() - t0 >= r.seconds \
                and (prof is not None or not r.trace):
            break
    _sync(dev)
    rec["window_s"] = time.perf_counter() - t0
    rec.update(steps=n, tokens=n * rows * seq, attempted=n, failed=0,
               trace=trace.reduce(prof), profiled_steps=prof_steps)
    rec["routing"] = moe.routing_counters(counts, state["router_bias"],
                                          mcfg.held_experts)
    rec["routing"]["retaken_steps"] = retaken
    if dev.type == "cuda":
        rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["memory_peak_bytes"] = max(peak_setup, rec["peak_window_bytes"])

    # free the program's state, then follow the checked steps
    del params, opt, step, state, out
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = RM.train_steps(p0, [batches[i] for i in range(checked)], cfg, dev,
                         chunk=tr["ref_chunk"])
    rec["reference_s"] = time.perf_counter() - t
    rec["numbers"] = numbers(got, ref, cfg)
    rec["compared"] = {"program": got, "reference": ref}
    return rec
