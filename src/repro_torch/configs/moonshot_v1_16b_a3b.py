"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16)
d_ff=1408/expert vocab=163840, MoE 64e top-6 (+2 shared experts per
Moonlight-16B-A3B hf config). [hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, with_moba)


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=163840,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                      expert_d_ff=1408),
        attention=AttentionConfig(rope_theta=5e6),
        layer_pattern=("dense",))
    return with_moba(cfg, block_size, top_k, key_conv_width) if moba else cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="moonshot-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=2,
                      expert_d_ff=32),
        layer_pattern=("dense",), dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
