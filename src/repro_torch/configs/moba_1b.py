"""The paper's own 1B model — 24L hidden=2048 32H head_dim=64
intermediate=8192, Llama-2 tokenizer (32K vocab), 8K context. (paper §5.1)"""
from repro_torch.configs.base import (AttentionConfig, MoBAConfig, ModelConfig)


def get_config(block_size: int = 128, top_k: int = 8,
               key_conv_width: int = 0, dense_baseline: bool = False
               ) -> ModelConfig:
    moba = MoBAConfig(block_size=block_size, top_k=top_k,
                      key_conv_width=key_conv_width)
    return ModelConfig(
        name=f"moba-1b-B{block_size}"
             + (f"-kconv{key_conv_width}" if key_conv_width else "")
             + ("-dense" if dense_baseline else ""),
        family="dense",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=8192, vocab_size=32000, max_seq_len=8192,
        attention=AttentionConfig(kind="moba", moba=moba, window=256,
                                  rope_on_moba=False),
        layer_pattern=("swa", "dense") if dense_baseline
        else ("swa", "moba"))


def get_smoke_config(**kw) -> ModelConfig:
    moba = MoBAConfig(block_size=16, top_k=2)
    return ModelConfig(
        name="moba-1b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        attention=AttentionConfig(kind="moba", moba=moba, window=32,
                                  rope_on_moba=False),
        layer_pattern=("swa", "moba"), dtype="float32")
