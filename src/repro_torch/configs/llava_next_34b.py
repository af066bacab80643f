"""LLaVA-NeXT-34B backbone (Yi-34B-style LM) — 60L, d7168, 56H (GQA kv=8),
d_ff 20480. The anyres vision tower is the stubbed frontend: inputs carry
precomputed patch embeddings [B, P, d_model].
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=("attn",),
    rope_theta=5e6,
    frontend="vision_patches",
    num_patches=576,
)

SMOKE_CONFIG = ModelConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_pattern=("attn",),
    rope_theta=1e4,
    frontend="vision_patches",
    num_patches=8,
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="pod", microbatch=16)
