"""MusicGen-large backbone — 48L, d2048, 32H (MHA), d_ff 8192, decoder-only
over EnCodec tokens (vocab 2048). The EnCodec codec is the stubbed
frontend: inputs are precomputed audio-code token ids.
[arXiv:2306.05284; hf]"""

from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=("attn",),
    rope_theta=1e4,
    frontend="audio_codec",
)

SMOKE_CONFIG = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    block_pattern=("attn",),
    rope_theta=1e4,
    frontend="audio_codec",
    param_dtype="float32",
    compute_dtype="float32",
)

TRAIN_CONFIG = TrainConfig(agent_layout="data", microbatch=8)
