"""Jamba-1.5-Large — 72L, d8192, 64H (GQA kv=8), d_ff 24576, Mamba:attn
7:1 interleave, MoE (16 experts top-2) on every other layer. Attention
layers use NoPE (rope_theta=0). [arXiv:2403.19887; hf]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=(
        "mamba", "mamba_moe", "mamba", "mamba_moe",
        "attn", "mamba_moe", "mamba", "mamba_moe",
    ),
    num_experts=16,
    num_experts_per_token=2,
    rope_theta=0.0,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_pattern=(
        "mamba", "mamba_moe", "mamba", "mamba_moe",
        "attn", "mamba_moe", "mamba", "mamba_moe",
    ),
    num_experts=4,
    num_experts_per_token=2,
    capacity_factor=8.0,  # droppless: decode≡train for consistency tests
    rope_theta=0.0,
    ssm_state_dim=4,
    ssm_conv_dim=2,
    ssm_expand=2,
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="pod", microbatch=16)
