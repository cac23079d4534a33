"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416, qwen1.5 arch (MHA-equivalent kv count, no qk-norm).
[hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, with_moba


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
        head_dim=128, d_ff=13440, vocab_size=92416,
        attention=AttentionConfig(rope_theta=1e6),
        layer_pattern=("dense",))
    return with_moba(cfg, block_size, top_k, key_conv_width) if moba else cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="codeqwen1.5-7b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, layer_pattern=("dense",), dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
