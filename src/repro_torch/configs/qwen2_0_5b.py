"""Qwen2-0.5B — 24L, d896, 14H (GQA kv=2), d_ff 4864, QKV bias.
[arXiv:2407.10671; hf]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
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
