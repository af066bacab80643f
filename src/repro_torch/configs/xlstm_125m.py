"""xLSTM-125M — 12 blocks, d768, mLSTM:sLSTM 3:1, GPT-2 vocabulary.
[arXiv:2405.04517; unverified]. d_ff=0: xLSTM blocks carry their own
projections; no separate FFN (DESIGN.md §5)."""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_heads=4,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-125m-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_heads=2,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="data", microbatch=4)
