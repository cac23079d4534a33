"""seamless-m4t-medium [audio] — 12L enc + 12L dec d_model=1024 16H
(kv=16) d_ff=4096 vocab=256206, enc-dec multimodal. [arXiv:2308.11596]

The audio frontend is a STUB: callers hand precomputed frame embeddings
(B, T_src, d) to the encoder; the decoder is causal with cross-attention
on the encoder's output.  MoBA applies to the decoder's self-attention
and to the encoder's (``encoder_bidirectional_moba``); cross-attention
stays dense.  The flag's name says bidirectional, but the encoder's MoBA
is causal in the code: MoBA prefill reads ``MoBAConfig.causal`` (True)
and ignores the encoder's ``causal=False``, in the reference as here
(ROADMAP.md §C).  With ``moba=False`` the dense encoder is
bidirectional."""
from repro_torch.configs.base import ModelConfig, with_moba

NUM_AUDIO_FRAMES = 1024


def get_config(moba: bool = True, block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0) -> ModelConfig:
    cfg = ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        num_layers=12, num_encoder_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=256206,
        num_audio_frames=NUM_AUDIO_FRAMES,
        layer_pattern=("decoder",))
    return with_moba(cfg, block_size, top_k, key_conv_width) if moba else cfg


def get_smoke_config(moba: bool = True) -> ModelConfig:
    cfg = ModelConfig(
        name="seamless-smoke", family="encdec",
        num_layers=2, num_encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=256, num_audio_frames=32,
        layer_pattern=("decoder",), dtype="float32")
    return with_moba(cfg, 16, 2) if moba else cfg
