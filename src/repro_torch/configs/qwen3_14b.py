"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm, GQA. [hf:Qwen/Qwen3-8B family; head_dim=128]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, with_moba


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="qwen3-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=17408, vocab_size=151936,
        attention=AttentionConfig(qk_norm=True, rope_theta=1e6),
        layer_pattern=("dense",))
    return with_moba(cfg, block_size, top_k, key_conv_width) if moba else cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="qwen3-14b-smoke", family="dense",
        num_layers=2, d_model=80, num_heads=5, num_kv_heads=1, head_dim=16,
        d_ff=160, vocab_size=256,
        attention=AttentionConfig(qk_norm=True),
        layer_pattern=("dense",), dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
