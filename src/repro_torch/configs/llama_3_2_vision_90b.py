"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256, cross-attn image layers every 5th layer
(20 cross + 80 self). [hf:meta-llama/Llama-3.2-11B-Vision family]

Vision frontend is a STUB: callers hand precomputed patch embeddings
(B, n_img, d_model) to the cross-attention layers.  MoBA applies to the
80 self-attention layers; cross-attention stays dense (short image
memory), takes no RoPE and keeps no cache: its K/V are projected from
the image embeddings in every step, as in the reference."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, with_moba

NUM_IMAGE_TOKENS = 1601


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=128256,
        num_image_tokens=NUM_IMAGE_TOKENS,
        attention=AttentionConfig(rope_theta=5e5),
        layer_pattern=("dense", "dense", "dense", "dense", "cross"))
    return with_moba(cfg, block_size, top_k, key_conv_width) if moba else cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="llama-vision-smoke", family="vlm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_image_tokens=8,
        layer_pattern=("dense", "cross"), dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
