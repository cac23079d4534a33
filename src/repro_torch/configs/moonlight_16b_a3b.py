"""Moonlight-16B-A3B [latent MoE] — 27L d_model=2048, MLA with 16 heads
(q/k 128 + 64 RoPE, v 128, kv latent 512, no query latent), one leading
dense layer (d_ff 11,264), then 26 layers of 64 routed experts (width
1,408, top-6 on sigmoid scores plus a selection bias, weights
renormalised and scaled by 2.446) and 2 shared experts; RoPE θ 50,000;
vocab 163,840.  [hf:moonshotai/Moonlight-16B-A3B, model_type
deepseek_v3]

Every attention layer runs MoBA (block 128, top_k 8, own block forced,
causal), as ``with_moba`` makes a full-attention layer.  ``held`` cuts
the model to one device's share of an expert-parallel deployment:
``held_count`` routed experts from ``held_first`` in every MoE layer
(the router keeps all 64 outputs and its 6 a token) and ``vocab_size``
the device's slice of the vocabulary.  This is not the older
``moonshot_v1_16b_a3b`` module, which mirrors the JAX package's config
(48 GQA layers, softmax routing with capacity) and is not the published
model."""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, LatentMoEConfig,
                                      MLAConfig, MoBAConfig, MoEConfig,
                                      RouterConfig)


def get_config(held_first: int = 0, held_count: int = 0,
               vocab_size: int = 163840) -> LatentMoEConfig:
    """The published widths and depth; ``held_count`` experts from
    ``held_first`` (0: all 64) and a ``vocab_size`` slice for a device's
    share."""
    return LatentMoEConfig(
        name="moonlight-16b-a3b", family="latent_moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=192, d_ff=11264, vocab_size=vocab_size,
        max_seq_len=8192, rms_norm_eps=1e-5,
        attention=AttentionConfig(
            kind="moba", moba=MoBAConfig(block_size=128, top_k=8),
            rope_theta=50000.0),
        layer_pattern=("moba",),
        moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                      expert_d_ff=1408),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        router=RouterConfig(routed_scale=2.446, seq_aux_coef=1e-4,
                            bias_rate=1e-3, held_first=held_first,
                            held_count=held_count),
        first_k_dense=1, dtype="bfloat16", param_dtype="float32")


def get_smoke_config(held_first: int = 0,
                     held_count: int = 0) -> LatentMoEConfig:
    """The same mechanisms at a CPU test's size: 3 layers (one dense),
    d_model 64, 4 heads of q/k 24 + 8 and v 16, latent 16, the router's
    64 experts and 6 a token at width 32 with 2 shared, MoBA block 16 /
    top_k 2, fp32."""
    full = get_config()
    return dataclasses.replace(
        full, name="moonlight-smoke", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=96, vocab_size=256,
        max_seq_len=256,
        attention=dataclasses.replace(
            full.attention, moba=MoBAConfig(block_size=16, top_k=2)),
        moe=dataclasses.replace(full.moe, expert_d_ff=32),
        mla=MLAConfig(kv_lora_rank=16, qk_nope_head_dim=24,
                      qk_rope_head_dim=8, v_head_dim=16),
        router=dataclasses.replace(full.router, held_first=held_first,
                                   held_count=held_count),
        dtype="float32")
