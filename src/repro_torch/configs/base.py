"""Model / training / serving configuration schema and registry.

Each assigned architecture gets a module ``repro/configs/<id>.py`` that
exports ``CONFIG`` (the exact published configuration) and
``SMOKE_CONFIG`` (a reduced same-family config for CPU tests). The
registry maps the CLI ``--arch`` ids to those modules.

``block_pattern`` is the central abstraction: the repeating group of
heterogeneous layer kinds; the model scans over ``num_layers /
len(block_pattern)`` groups. Kinds:

  attn / attn_moe      — full causal attention + MLP / MoE
  swa / swa_moe        — sliding-window attention + MLP / MoE
  local / global       — gemma2-style alternating SWA / full attention
  mamba / mamba_moe    — Mamba mixer + MLP / MoE
  mlstm / slstm        — xLSTM blocks (no FFN, per the architecture)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

ATTN_KINDS = {"attn", "attn_moe", "swa", "swa_moe", "local", "global"}
MOE_KINDS = {"attn_moe", "swa_moe", "mamba_moe"}
RECURRENT_KINDS = {"mamba", "mamba_moe", "mlstm", "slstm"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...] = ("attn",)
    head_dim: int | None = None
    sliding_window: int | None = None    # for swa/local kinds
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False            # gemma: scale embeddings by √d
    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    # xLSTM
    mlstm_heads: int = 4
    # Modality frontends (STUBS — input_specs provides embeddings)
    frontend: str | None = None          # None | "audio_codec" | "vision_patches"
    num_patches: int = 576
    # Numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}"
            )
        if any(k in MOE_KINDS for k in self.block_pattern):
            if self.num_experts <= 0 or self.num_experts_per_token <= 0:
                raise ValueError(f"{self.name}: MoE kinds need expert counts")
        for k in self.block_pattern:
            if k not in ATTN_KINDS | RECURRENT_KINDS:
                raise ValueError(f"{self.name}: unknown block kind {k!r}")
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads not divisible by kv heads")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """True if every layer is sub-quadratic in context (SSM or SWA)."""
        return all(
            k in RECURRENT_KINDS or k in ("swa", "swa_moe")
            for k in self.block_pattern
        ) or self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Distributed-training knobs for one (arch × shape) cell."""

    agent_layout: str = "data"     # "data": agents on (pod×)data axis, TP on
                                   # model; "pod": agents on pod axis,
                                   # FSDP on data + TP on model (big archs)
    remat: str = "full"            # "none" | "full" — activation ckpt policy
    learning_rate: float = 0.01
    momentum: float = 0.9
    gossip: str = "auto"           # "auto" | "sparse" | "allreduce"
    microbatch: int = 0            # >0: gradient accumulation steps
    moe_aux_weight: float = 1e-2
    router_z_weight: float = 1e-3


ARCH_IDS = (
    "mixtral-8x22b",
    "mixtral-8x7b",
    "xlstm-125m",
    "qwen1.5-0.5b",
    "mistral-large-123b",
    "gemma2-2b",
    "qwen2-0.5b",
    "musicgen-large",
    "jamba-1.5-large-398b",
    "llava-next-34b",
)

_MODULE_FOR_ARCH = {
    "mixtral-8x22b": "mixtral_8x22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "xlstm-125m": "xlstm_125m",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "musicgen-large": "musicgen_large",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-34b": "llava_next_34b",
}


def _config_module(arch: str):
    """The port's own copy of ``arch``'s config module."""
    import importlib

    return importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR_ARCH[arch]}"
    )


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = _config_module(arch)
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def get_train_config(arch: str) -> TrainConfig:
    mod = _config_module(arch)
    return getattr(mod, "TRAIN_CONFIG", TrainConfig())


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def cell_is_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch × shape) runs; reason recorded in EXPERIMENTS.md."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} has full-attention layers (DESIGN.md §5)"
        )
    return True, ""
