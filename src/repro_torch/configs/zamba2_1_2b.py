"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

Layout: 2 groups × (18 mamba2 blocks + 1 shared-weight attention block)
= 38 layers; the attention block's parameters are a single shared copy
(zamba2's signature trick).  ``moba=True`` sets ``attention.kind`` to
MoBA, but the shared block runs dense attention all the same:
``models/transformer.py::apply_block`` resolves ``shared_attn`` to
dense, as the reference's code does (ROADMAP.md §C)."""
from repro_torch.configs.base import ModelConfig, SSMConfig, with_moba

_PATTERN = ("ssm",) * 9 + ("shared_attn",) + ("ssm",) * 9


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=8192, vocab_size=32000,
        ssm=SSMConfig(state_size=64, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256),
        layer_pattern=_PATTERN, tie_embeddings=True)
    if moba:
        cfg = with_moba(cfg, block_size, top_k, key_conv_width)
        # shared_attn resolves to attention.kind — switch it to moba
        import dataclasses
        attn = dataclasses.replace(cfg.attention, kind="moba")
        cfg = dataclasses.replace(cfg, attention=attn)
    return cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        ssm=SSMConfig(state_size=16, head_dim=16, chunk_size=16),
        layer_pattern=("ssm", "shared_attn"), tie_embeddings=True,
        dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
