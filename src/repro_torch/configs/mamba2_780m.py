"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD. [arXiv:2405.21060]

MoBA is **inapplicable** (no attention layers to route) — see DESIGN.md
§Arch-applicability.  The arch still runs every assigned shape natively
(linear-time scan, recurrent decode)."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def get_config(moba: bool = True, **_) -> ModelConfig:
    # `moba` accepted for registry uniformity; it is a no-op here.
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(state_size=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256),
        layer_pattern=("ssm",), tie_embeddings=True)


def get_smoke_config(moba: bool = True) -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=1, num_kv_heads=1, d_ff=0,
        vocab_size=256,
        ssm=SSMConfig(state_size=16, head_dim=16, chunk_size=16),
        layer_pattern=("ssm",), tie_embeddings=True, dtype="float32")
