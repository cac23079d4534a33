"""Config system: dataclasses describing models, MoBA, meshes and runs.

Every assigned architecture gets one module in ``repro_torch.configs`` exposing
``get_config() -> Config`` (the exact published shape) and
``get_smoke_config() -> Config`` (a reduced same-family config for CPU
smoke tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoBAConfig:
    """Mixture of Block Attention hyper-parameters (Lu et al. 2025; Xiao et
    al. 2025).

    ``block_size`` is the MoBA key-block size B; ``top_k`` the number of
    selected blocks per query *including* the always-selected current block
    (matching the paper's 7/8-sparsity accounting).  ``key_conv_width`` of 0
    disables key convolution; 3/5 give the paper's kconv3/kconv5.
    """

    block_size: int = 128
    top_k: int = 8
    key_conv_width: int = 0
    # Selection scores use raw q·k̃ (paper); attention uses 1/sqrt(d).
    causal: bool = True

    def validate(self) -> None:
        assert self.block_size > 0 and self.top_k > 0
        assert self.key_conv_width in (0, 2, 3, 4, 5, 7)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Per-layer attention behaviour.

    ``kind``: 'dense' | 'swa' | 'moba'.  ``pattern`` in ModelConfig decides
    which layers use which kind (paper interleaves swa/moba).
    """

    kind: str = "dense"
    window: int = 256  # for swa
    moba: Optional[MoBAConfig] = None
    use_rope: bool = True
    rope_on_moba: bool = True  # paper's hybrid uses NoPE on MoBA layers
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # softmax scale override; None -> 1/sqrt(head_dim)
    scale: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    num_shared_experts: int = 0
    expert_d_ff: int = 0  # per-expert hidden size
    router_aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyper-parameters."""

    state_size: int = 128
    head_dim: int = 64
    num_heads: int = 0        # derived if 0: d_inner / head_dim
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # derived if 0: d_model / num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    rms_norm_eps: float = 1e-6
    # attention layout: a repeating pattern of per-layer attention kinds,
    # e.g. ("swa", "moba"). Length must divide num_layers.
    attention: AttentionConfig = dataclasses.field(
        default_factory=AttentionConfig)
    layer_pattern: Tuple[str, ...] = ("dense",)
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    ssm: SSMConfig = dataclasses.field(default_factory=SSMConfig)
    # hybrid (zamba2-style): pattern entries may be "ssm" as well.
    # encdec:
    num_encoder_layers: int = 0
    encoder_bidirectional_moba: bool = True
    # vlm: insert one cross-attn layer every `cross_attn_every` layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # audio frontend stub
    num_audio_frames: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention's widths (DeepSeek-V2 §2.1): keys and
    values come up from a ``kv_lora_rank`` latent (after its RMSNorm),
    queries from one projection (no query latent); each query/key head is
    ``qk_nope_head_dim`` + ``qk_rope_head_dim`` wide, the RoPE part of the
    key one vector shared by every head; values are ``v_head_dim``
    wide."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """DeepSeek-V3's routing (§2.1.2): sigmoid scores over every expert,
    the top ``MoEConfig.top_k`` chosen on scores plus a per-expert bias
    that is no parameter (moved by ``bias_rate`` · sign after each
    optimizer step), the chosen scores renormalised and scaled by
    ``routed_scale``; a sequence-wise balance loss of weight
    ``seq_aux_coef``.  Nothing is dropped.  The layer computes the routed
    part of ``held_count`` experts from ``held_first`` (0: every expert):
    one device's share under expert parallelism."""

    routed_scale: float = 1.0
    seq_aux_coef: float = 1e-4
    bias_rate: float = 1e-3
    held_first: int = 0
    held_count: int = 0


@dataclasses.dataclass(frozen=True)
class LatentMoEConfig(ModelConfig):
    """A DeepSeek-V3-style model: every layer's attention is latent (MLA,
    ``mla``) and runs as ``attention.kind`` over q/k ``mla.qk_head_dim``
    and v ``mla.v_head_dim``; the first ``first_k_dense`` layers have a
    SwiGLU MLP of width ``d_ff``, the rest sigmoid-routed experts
    (``moe``, ``router``).  ``num_heads`` counts the attention heads
    (every head has its own key and value)."""

    mla: MLAConfig = dataclasses.field(default_factory=MLAConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    first_k_dense: int = 1

    @property
    def held_experts(self) -> Tuple[int, int]:
        """(first, count) of the routed experts this model's layers hold."""
        r = self.router
        return r.held_first, r.held_count or self.moe.num_experts


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Logical sharding strategy knobs."""

    fsdp: bool = True              # shard params/opt over data axes (ZeRO-3)
    tensor_parallel: bool = True   # Megatron TP over "model"
    expert_parallel: bool = True   # MoE experts over "model"
    sequence_parallel: bool = False  # shard long KV over data axes (decode CP)
    remat: str = "dots"            # none | dots | full
    grad_compression: str = "none"  # none | int8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch_size: int = 8
    seq_len: int = 512
    learning_rate: float = 6e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0  # 0 = no gradient accumulation
    seed: int = 0
    checkpoint_dir: str = ""
    save_interval: int = 200
    keep_checkpoints: int = 3


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8
    kv_len: int = 4096
    prefill_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    sharding: ShardingConfig = dataclasses.field(
        default_factory=ShardingConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)


def with_moba(cfg: ModelConfig, block_size: int = 128, top_k: int = 8,
              key_conv_width: int = 0) -> ModelConfig:
    """Return a copy of ``cfg`` with its full-attention layers switched to
    MoBA (the paper's technique), leaving swa/ssm/cross layers untouched."""
    moba = MoBAConfig(block_size=block_size, top_k=top_k,
                      key_conv_width=key_conv_width)
    attn = dataclasses.replace(cfg.attention, kind="moba", moba=moba)
    pattern = tuple("moba" if p == "dense" else p for p in cfg.layer_pattern)
    return dataclasses.replace(cfg, attention=attn, layer_pattern=pattern)


# The four assigned LM shapes (seq_len, global_batch, kind).
ASSIGNED_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
