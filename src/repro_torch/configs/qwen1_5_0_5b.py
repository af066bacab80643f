"""Qwen1.5-0.5B — 24L, d1024, 16H (MHA), d_ff 2816, QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e4,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="data_dp", microbatch=1)
