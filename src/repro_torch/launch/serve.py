"""Serving on one card: prefill and decode steps of the model zoo.

Counterpart of the JAX package's ``launch/serve.py`` without its mesh and
shardings (those wait with ``launch/mesh.py`` and ``sharding.py``, ROADMAP
queue A): ``build_serve_artifacts(cfg, shape)`` returns both functions of
one card's serving loop and the shapes of what they take, read from the
``meta`` device in place of ``jax.eval_shape``:

  prefill_fn(params, inputs)       -> (logits [B, 1, V], caches)
  step_fn(params, caches, token)   -> (logits [B, 1, V], caches)

``shape.global_batch`` is the batch and ``shape.seq_len`` the depth of the
caches (``max_len``); a prompt may be shorter than that. The frontends are
the reference's: ``audio_codec`` takes codec token ids as ``tokens``;
``vision_patches`` takes ``tokens [B, seq_len - num_patches]`` and
``patch_embeds [B, num_patches, d_model]``, which fill the first
``num_patches`` positions. Both functions run under
``torch.inference_mode()``; ``step_fn`` writes the caches in place and
returns the same dict. Attention goes through the hand-written
``flash_attention`` (prefill) and ``decode_attention`` (decode) kernels on
the card; the recurrent blocks' state is torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import compat
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model


@dataclasses.dataclass
class ServeArtifacts:
    prefill_fn: Callable   # (params, inputs) -> (logits, caches)
    step_fn: Callable      # (params, caches, token) -> (logits, caches)
    param_shapes: Any      # tree of meta tensors
    cache_shapes: Any      # tree of meta tensors
    input_shapes: Any      # {"tokens": meta [B, S], ...} or meta token [B, 1]


def build_serve_artifacts(
    cfg: ModelConfig,
    shape: ShapeConfig,
    device: str | torch.device | None = None,
) -> ServeArtifacts:
    """Prefill and decode functions for ``cfg`` at ``shape`` on ``device``
    (``None`` means CUDA and raises without a card). ``input_shapes`` is
    the prompt for a ``prefill`` shape and one token per sequence for a
    ``decode`` shape."""
    dev = compat.resolve_device(device)
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    param_shapes = model.init(cfg, 0, device=meta)
    cache_shapes = model.init_caches(cfg, b, s, device=meta)
    vision = cfg.frontend == "vision_patches"
    if shape.kind == "decode":
        input_shapes = torch.empty((b, 1), dtype=torch.int32, device=meta)
    elif vision:
        input_shapes = {
            "tokens": torch.empty((b, s - cfg.num_patches), dtype=torch.int32,
                                  device=meta),
            "patch_embeds": torch.empty((b, cfg.num_patches, cfg.d_model),
                                        dtype=torch.bfloat16, device=meta),
        }
    else:
        input_shapes = {
            "tokens": torch.empty((b, s), dtype=torch.int32, device=meta)
        }
    input_keys = ("tokens", "patch_embeds") if vision else ("tokens",)

    def prefill_fn(params, inputs):
        with torch.inference_mode():
            moved = {key: inputs[key].to(dev) for key in input_keys}
            return model.prefill(cfg, params, moved, max_len=s)

    def step_fn(params, caches, token):
        with torch.inference_mode():
            return model.decode_step(cfg, params, caches, token.to(dev))

    return ServeArtifacts(
        prefill_fn=prefill_fn,
        step_fn=step_fn,
        param_shapes=param_shapes,
        cache_shapes=cache_shapes,
        input_shapes=input_shapes,
    )
