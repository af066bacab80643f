"""Gemma2-2B — 26L, d2304, 8H (GQA kv=4, head_dim 256), d_ff 9216,
alternating local(4096)/global attention, logit softcaps, tied + scaled
embeddings. [arXiv:2408.00118; hf]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=("local", "global"),
    head_dim=256,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-2b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_pattern=("local", "global"),
    head_dim=32,
    sliding_window=16,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=1e4,
    tie_embeddings=True,
    embed_scale=True,
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="data", microbatch=8)
