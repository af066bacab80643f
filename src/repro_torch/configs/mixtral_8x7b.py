"""Mixtral 8x7B — 32L, d4096, 32H (GQA kv=8), d_ff 14336, 8 experts top-2,
sliding-window attention. [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("swa_moe",),
    sliding_window=4096,
    num_experts=8,
    num_experts_per_token=2,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-8x7b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_pattern=("swa_moe",),
    sliding_window=16,
    num_experts=4,
    num_experts_per_token=2,
    capacity_factor=8.0,  # droppless: decode≡train for consistency tests
    rope_theta=1e4,
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="pod", microbatch=16)
