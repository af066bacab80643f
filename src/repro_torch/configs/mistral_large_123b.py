"""Mistral-Large-2407 — 88L, d12288, 96H (GQA kv=8), d_ff 28672.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    block_pattern=("attn",),
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    block_pattern=("attn",),
    rope_theta=1e4,
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="pod", microbatch=16)
