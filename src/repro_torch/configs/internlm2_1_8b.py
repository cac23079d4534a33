"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544, GQA. [arXiv:2403.17297]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, with_moba


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="internlm2-1.8b", family="dense",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=92544,
        attention=AttentionConfig(rope_theta=1e6),
        layer_pattern=("dense",))
    return with_moba(cfg, block_size, top_k, key_conv_width) if moba else cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="internlm2-1.8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, layer_pattern=("dense",), dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
