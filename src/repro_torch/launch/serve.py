"""Serving: prefill and decode steps of the model zoo, on one card or
batch-parallel across ranks.

Counterpart of the JAX package's ``launch/serve.py``:
``build_serve_artifacts(cfg, shape, device, mesh=None)`` returns both
functions of the serving loop and the shapes of what they take, read from
the ``meta`` device in place of ``jax.eval_shape``:

  prefill_fn(params, inputs)       -> (logits [B, 1, V], caches)
  step_fn(params, caches, token)   -> (logits [B, 1, V], caches)
  init_caches(params, rows)        -> empty caches for ``rows`` sequences

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

With a ``DeviceMesh`` (``launch.mesh.init_mesh``) each rank serves its
rows of the batch over ``("pod",) "data"``: it feeds both functions its
part of the inputs (``sharding.shard_tree(inputs, art.input_specs,
mesh)``), B/|data| rows when B divides, else all B rows on every rank
(the reference's ``role_axes["batch"] = ()``), and its part of the
weights (``sharding.shard_tree(params, art.param_specs, mesh)``): whole
on a ``model`` axis of 1, split along ``model`` above it (1-D tensor
parallelism, ``models/sharding_hints.py``), the caches then holding the
rank's KV heads and its block of Mamba's d_inner. ``input_specs``,
``param_specs`` and ``cache_specs`` say which part each rank holds (under
tensor parallelism ``cache_specs`` covers the batch dim only: a rank's
heads are not always a block of the whole, ``attention.head_plan``).
Where the rule picks 2-D tensor parallelism (weights over 8 GB a
``model`` rank), the leaves are split over ``data`` too: each group's
FSDP-split leaves are gathered whole over ``data`` as the group starts,
and the experts split along E over ``data`` stay with their owner, which
runs them on every ``data`` rank's rows (all-to-all there and back,
``models/moe.py``). The caches hold the rank's rows and KV heads, where
the reference's ``cache_specs_serve`` would also spread the sequence
over ``data`` when B does not divide.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import compat
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import model
from repro_torch.models.sharding_hints import hints
from repro_torch.tree import tree_map


@dataclasses.dataclass
class ServeArtifacts:
    prefill_fn: Callable   # (params, inputs) -> (logits, caches)
    step_fn: Callable      # (params, caches, token) -> (logits, caches)
    param_shapes: Any      # tree of meta tensors
    cache_shapes: Any      # tree of meta tensors
    input_shapes: Any      # {"tokens": meta [B, S], ...} or meta token [B, 1]
    param_specs: Any = None   # sharding.P trees on a DeviceMesh, else None
    cache_specs: Any = None
    input_specs: Any = None
    # (params, rows) -> empty caches of the depth, for ``rows`` sequences
    # at the widths of this rank's ``params``
    init_caches: Callable = None


def _mesh_specs(cfg, b: int, mesh: DeviceMesh, param_shapes, cache_shapes,
                input_shapes):
    """``(role_axes, FSDP plan, param_specs, cache_specs, input_specs)`` of
    the mesh path."""
    sizes = mesh_lib.axis_sizes(mesh)
    param_specs = sharding.param_specs_serve(param_shapes, mesh, cfg)
    batch_axes = mesh_lib.agent_axes(mesh, "data")   # ("pod",) "data"
    bsz = int(np.prod([sizes[a] for a in batch_axes]))
    split = b % bsz == 0 and b >= bsz
    role_axes = {"batch": batch_axes if split else (), "tp": ("model",),
                 "seq": ("model",)}
    serve_roles = sharding._role_axes_serve(mesh, cfg)
    role_axes.update(fsdp=serve_roles["fsdp"], ep=serve_roles["ep"])
    plan = sharding.fsdp_plan(param_specs, mesh, serve_roles["fsdp"])
    entry = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
        if split else None

    def rows(t):
        return sharding.P(entry, *([None] * (t.dim() - 1)))

    if sizes["model"] > 1:
        # the rank's rows; its heads / d_inner block are the model's own
        cache_specs = tree_map(
            lambda t: sharding.P(*([None] * t.dim())) if t.dim() < 2
            else sharding.P(None, entry, *([None] * (t.dim() - 2))),
            cache_shapes)
    elif split:
        # the reference's cache specs: batch over the batch axes, the rest
        # over "model" (size 1)
        cache_specs = sharding.cache_specs_serve(cache_shapes, mesh, cfg)
    else:
        cache_specs = tree_map(
            lambda t: sharding.P(*([None] * t.dim())), cache_shapes)
    return (role_axes, plan, param_specs, cache_specs,
            tree_map(rows, input_shapes))


def build_serve_artifacts(
    cfg: ModelConfig,
    shape: ShapeConfig,
    device: str | torch.device | None = None,
    mesh: DeviceMesh | None = None,
) -> ServeArtifacts:
    """Prefill and decode functions for ``cfg`` at ``shape`` on ``device``
    (``None`` means CUDA and raises without a card), for this rank's rows
    of the batch and its part of the weights on a ``DeviceMesh`` (module
    docstring). ``input_shapes``
    is the prompt for a ``prefill`` shape and one token per sequence for a
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
    specs = (None, None, None)
    role_axes: dict = {}
    plan = None
    if mesh is not None:
        role_axes, plan, *specs = _mesh_specs(
            cfg, b, mesh, param_shapes, cache_shapes, input_shapes)

    def prefill_fn(params, inputs):
        with torch.inference_mode(), hints(role_axes, mesh, plan):
            moved = {key: inputs[key].to(dev) for key in input_keys}
            return model.prefill(cfg, params, moved, max_len=s)

    def step_fn(params, caches, token):
        with torch.inference_mode(), hints(role_axes, mesh, plan):
            return model.decode_step(cfg, params, caches, token.to(dev))

    def init_caches(params, rows: int):
        with torch.inference_mode(), hints(role_axes, mesh, plan):
            return model.init_caches(cfg, rows, s, dev, params)

    return ServeArtifacts(
        prefill_fn=prefill_fn,
        step_fn=step_fn,
        param_shapes=param_shapes,
        cache_shapes=cache_shapes,
        input_shapes=input_shapes,
        param_specs=specs[0],
        cache_specs=specs[1],
        input_specs=specs[2],
        init_caches=init_caches,
    )
