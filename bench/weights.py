"""The benchmark's weights and inputs, made on the device from ``--seed``.

One ``torch.Generator`` on the device draws every leaf whole (a few
dozen large calls, fp32, the type the program keeps its parameters in),
in the stacked layout both the program and the reference read:
``blocks/slot_i`` leaves carry a leading layer-group axis.  Scales:
embedding N(0, embed_std²), matrices N(0, 1/fan_in), norm scales 1.
"""
from __future__ import annotations

from typing import Dict

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed``: the
    weights are stream 0; inputs take their own streams."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) & SEED_MASK)
    return g


def make_params(cfg: dict, seed: int, device) -> Dict:
    """The model's parameters of ``cfg`` for ``seed`` on ``device``."""
    if cfg["tie_embeddings"] or cfg["moba"]["key_conv_width"] \
            or cfg["attention"]["qk_norm"]:
        raise ValueError("tied embeddings, key convolution and q/k norms "
                         "have no weights here yet")
    g = generator(seed, device)
    d, h, hkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    dh = cfg["head_dim"] or d // h
    pattern = cfg["layer_pattern"]
    n = cfg["num_layers"] // len(pattern)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device).mul_(std)

    def matrix(lead, fan_in, fan_out):
        return normal(lead + (fan_in, fan_out), fan_in ** -0.5)

    def ones(shape):
        return torch.ones(shape, device=device)

    params = {"embed": normal((cfg["vocab_size"], d),
                              cfg["init"]["embed_std"]),
              "final_norm": ones((d,)),
              "lm_head": matrix((), d, cfg["vocab_size"]),
              "blocks": {}}
    for i, kind in enumerate(pattern):
        if kind not in ("swa", "moba", "dense"):
            raise ValueError(f"no weights for a {kind!r} layer")
        params["blocks"][f"slot_{i}"] = {
            "norm1": ones((n, d)), "norm2": ones((n, d)),
            "attn": {"wq": matrix((n,), d, h * dh),
                     "wk": matrix((n,), d, hkv * dh),
                     "wv": matrix((n,), d, hkv * dh),
                     "wo": matrix((n,), h * dh, d)},
            "mlp": {"w_gate": matrix((n,), d, cfg["d_ff"]),
                    "w_up": matrix((n,), d, cfg["d_ff"]),
                    "w_down": matrix((n,), cfg["d_ff"], d)}}
    return params


def train_batches(cfg: dict, seed: int, count: int, rows: int, seq: int,
                  device) -> torch.Tensor:
    """``count`` batches of ``rows`` rows of ``seq`` + 1 uniform token ids
    (int64), every row drawn anew."""
    g = generator(seed, device, stream=1)
    return torch.randint(0, cfg["vocab_size"], (count, rows, seq + 1),
                         generator=g, device=device)
