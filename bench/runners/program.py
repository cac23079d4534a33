"""The configuration files of ``configs/`` as the program's config
objects."""
from __future__ import annotations


def model_config(cfg: dict):
    """``repro_torch.configs.base.ModelConfig`` of a configuration file."""
    from repro_torch.configs import base

    a, m = cfg["attention"], cfg["moba"]
    moba = base.MoBAConfig(block_size=m["block_size"], top_k=m["top_k"],
                           key_conv_width=m["key_conv_width"],
                           causal=m["causal"])
    attn = base.AttentionConfig(
        kind="moba", window=a["window"], moba=moba, use_rope=a["use_rope"],
        rope_on_moba=a["rope_on_moba"], qk_norm=a["qk_norm"],
        rope_theta=a["rope_theta"])
    return base.ModelConfig(
        name=cfg["name"], family=cfg["family"],
        num_layers=cfg["num_layers"], d_model=cfg["d_model"],
        num_heads=cfg["num_heads"], num_kv_heads=cfg["num_kv_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["d_ff"],
        vocab_size=cfg["vocab_size"], max_seq_len=cfg["max_seq_len"],
        tie_embeddings=cfg["tie_embeddings"],
        rms_norm_eps=cfg["rms_norm_eps"], attention=attn,
        layer_pattern=tuple(cfg["layer_pattern"]), dtype=cfg["dtype"],
        param_dtype=cfg["param_dtype"])


def train_config(cfg: dict, rows: int, seq: int, microbatch: int):
    """``repro_torch.configs.base.TrainConfig`` of a configuration file's
    optimizer recipe at ``rows`` × ``seq``, in ``microbatch`` chunks of
    rows (1: the whole batch at once)."""
    from repro_torch.configs import base

    t = cfg["train"]
    return base.TrainConfig(
        global_batch_size=rows, seq_len=seq,
        learning_rate=t["learning_rate"], warmup_steps=t["warmup_steps"],
        total_steps=t["total_steps"], weight_decay=t["weight_decay"],
        beta1=t["beta1"], beta2=t["beta2"], grad_clip=t["grad_clip"],
        microbatch=microbatch)
