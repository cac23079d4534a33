"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408/expert
vocab=151936, MoE 60e top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, with_moba)


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=151936,
        moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                      expert_d_ff=1408),
        attention=AttentionConfig(rope_theta=1e6),
        layer_pattern=("dense",))
    return with_moba(cfg, block_size, top_k, key_conv_width) if moba else cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="qwen2-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=256,
        moe=MoEConfig(num_experts=6, top_k=2, num_shared_experts=2,
                      expert_d_ff=32),
        layer_pattern=("dense",), dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
