"""Mixtral 8x22B — 56L, d6144, 48H (GQA kv=8), d_ff 16384, 8 experts top-2,
sliding-window attention. [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    block_pattern=("swa_moe",),
    sliding_window=4096,
    num_experts=8,
    num_experts_per_token=2,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-8x22b-smoke",
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
