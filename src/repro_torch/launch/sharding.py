"""Sharding rules: partition specs for params, batches and caches.

Counterpart of the JAX package's ``launch/sharding.py``; the rules are
its own, as pure functions over the port's trees (paths from
``tree.tree_paths``, the reference's keys) and either kind of mesh
(``launch.mesh.axis_sizes``). A spec is ``P``: a tuple of one entry per
dim — None, an axis name, or a tuple of names — that compares entry for
entry with ``tuple(jax.sharding.PartitionSpec(...))``.

Roles (resolved to mesh axes per layout):
  agent — stacked D-PSGD agent dim (dim 0 of every train leaf)
  fsdp  — intra-agent parameter/optimizer sharding ("pod" layout only)
  tp    — tensor parallelism over the "model" axis
  ep    — expert parallelism (MoE expert dim)

Train layouts (TrainConfig.agent_layout):
  "data":    agents on ("pod"×)"data"; TP over "model".
  "data_dp": agents on ("pod"×)"data"; weights replicated over "model",
             which splits each agent's microbatch instead.
  "pod":     one agent per pod; FSDP over "data" + TP over "model".

Serving has no agents: weights are TP-sharded over "model", and for big
archs additionally over "data" (2-D tensor parallelism); caches shard
batch over ("pod","data") and sequence over "model".

The rules are divisibility-safe: an axis is only assigned if the dim
divides evenly, else dropped.

The port acts on these specs with explicit local tensors: ``shard_tree``
slices a replicated tree to the calling rank's local leaves with no
communication, ``gather_tree`` gathers them back, and the model runs on
the local leaves (``models/sharding_hints.py``): tensor parallelism over
"model", and where a rule splits a leaf over "data" (the ``pod`` layout,
serving's 2-D tensor parallelism), FSDP — the leaf gathered whole at its
use, ``fsdp_plan`` says along which dim — or expert parallelism, the
experts staying with their owner.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_map, tree_map_with_path


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``."""

    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# (pattern, per-dim roles from the END of the shape). Earlier entries win.
# Dims not covered (leading stacked dims G) get None; dim 0 agent handled
# separately. Roles per dim: tuple of candidate roles tried in order.
_PARAM_RULES: tuple[tuple[str, tuple[tuple[str, ...], ...]], ...] = (
    # xLSTM mixer projections: REPLICATED. TP-sharding them was measured
    # forcing ~300 MB activation all-reduces per layer per microbatch
    # (the 4 mLSTM heads cannot align with a 16-way model axis); the
    # model is ≤125M params, so replication is free (§Perf).
    (r"mixer/(up|down)/kernel$", ((), ())),
    # MoE stacked experts [*, E, D, F] / [*, E, F, D]
    (r"ffn/(gate|up)$", (("ep",), ("fsdp",), ("tp",))),
    (r"ffn/down$", (("ep",), ("tp",), ("fsdp",))),
    (r"router/kernel$", (("fsdp",), ())),
    # Attention / MLP projections
    (r"(wq|wk|wv)/kernel$", (("fsdp",), ("tp",))),
    (r"(wq|wk|wv)/bias$", (("tp",),)),
    (r"wo/kernel$", (("tp",), ("fsdp",))),
    (r"(gate|up)/kernel$", (("fsdp",), ("tp",))),
    (r"down/kernel$", (("tp",), ("fsdp",))),
    # Embeddings
    (r"(embed|unembed)/table$", (("tp",), ("fsdp",))),
    (r"patch_proj/kernel$", (("fsdp",), ("tp",))),
    # Mamba
    (r"in_proj/kernel$", (("fsdp",), ("tp",))),
    (r"out_proj/kernel$", (("tp",), ("fsdp",))),
    (r"mixer/conv$", ((), ("tp",))),
    (r"conv_bias$", (("tp",),)),
    (r"x_proj/kernel$", (("tp",), ())),
    (r"dt_proj/kernel$", ((), ("tp",))),
    (r"(dt_bias|d_skip)$", (("tp",),)),
    (r"a_log$", (("tp",), ())),
    # xLSTM: up/down projected; per-head block-diag weights replicated
    (r"mixer/up/kernel$", (("fsdp",), ("tp",))),
    (r"mixer/down/kernel$", (("tp",), ("fsdp",))),
)


def _size(mesh, axes) -> int:
    sizes = mesh_lib.axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _entry(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def _assign(shape, roles_from_end, role_axes, mesh) -> P:
    """Build a spec assigning roles to trailing dims, divisibility-safe.

    Each mesh axis is used at most once per leaf.
    """
    spec: list = [None] * len(shape)
    used: set[str] = set()
    n = len(roles_from_end)
    for i, roles in enumerate(roles_from_end):
        dim = len(shape) - n + i
        if dim < 0:
            continue
        for role in roles:
            axes = role_axes.get(role, ())
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                continue
            size = _size(mesh, axes)
            if shape[dim] % size == 0 and shape[dim] >= size:
                spec[dim] = _entry(axes)
                used.update(axes)
                break
    return P(*spec)


def _role_axes_train(mesh, layout: str) -> dict:
    has_pod = "pod" in mesh_lib.axis_names(mesh)
    agent = ("pod", "data") if has_pod else ("data",)
    if layout == "data":
        return {"agent": agent, "fsdp": (), "tp": ("model",), "ep": (),
                "batch_inner": ()}
    if layout == "data_dp":
        # Small models: replicate weights over "model" and use it as
        # intra-agent data parallelism.
        return {"agent": agent, "fsdp": (), "tp": (), "ep": (),
                "batch_inner": ("model",)}
    if layout == "pod":
        return {
            "agent": (("pod",) if has_pod else ()),
            "fsdp": ("data",),
            "tp": ("model",),
            "ep": ("data",),  # EP and FSDP share the data axis (either/or)
            "batch_inner": ("data",),
        }
    raise ValueError(layout)


def _rules_for(path: str):
    for pat, roles in _PARAM_RULES:
        if re.search(pat, path):
            return roles
    return None


def _agent_entry(dim0: int, agent, mesh):
    if agent and dim0 % _size(mesh, agent) == 0:
        return _entry(agent)
    return None


def param_specs_train(params_shape: Any, mesh, layout: str) -> Any:
    """Specs for stacked-agent train params (leaf dim 0 = agent)."""
    role_axes = _role_axes_train(mesh, layout)
    agent = role_axes["agent"]

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        inner = shape[1:]  # strip agent dim
        rules = _rules_for(path)
        if rules is None:
            inner_spec = P(*([None] * len(inner)))
        else:
            inner_spec = _assign(inner, rules, role_axes, mesh)
        return P(_agent_entry(shape[0], agent, mesh), *inner_spec)

    return tree_map_with_path(spec_for, params_shape)


def batch_specs_train(batch_shape: Any, mesh, layout: str) -> Any:
    """Batch leaves are [A, per_agent_B, ...]: agent dim + inner-batch
    sharding per layout (fsdp for "pod", "model" for "data_dp")."""
    role_axes = _role_axes_train(mesh, layout)
    agent, inner = role_axes["agent"], role_axes["batch_inner"]

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        b1 = None
        if inner and len(shape) > 1 and shape[1] % _size(mesh, inner) == 0:
            b1 = _entry(inner)
        return P(_agent_entry(shape[0], agent, mesh), b1,
                 *([None] * (len(shape) - 2)))

    return tree_map_with_path(spec_for, batch_shape)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _role_axes_serve(mesh, cfg: ModelConfig) -> dict:
    """2-D TP for big archs (weights > ~8 GB per model shard), else 1-D."""
    from repro_torch.models import model

    bytes_total = model.parameter_count(cfg) * 2  # bf16
    two_d = bytes_total / mesh_lib.axis_sizes(mesh)["model"] > 8e9
    return {
        "agent": (),
        "fsdp": ("data",) if two_d else (),
        "tp": ("model",),
        "ep": ("data",) if two_d else (),
    }


def param_specs_serve(params_shape: Any, mesh, cfg: ModelConfig) -> Any:
    role_axes = _role_axes_serve(mesh, cfg)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        rules = _rules_for(path)
        if rules is None:
            return P(*([None] * len(shape)))
        return _assign(shape, rules, role_axes, mesh)

    return tree_map_with_path(spec_for, params_shape)


def _batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_lib.axis_names(mesh) else ("data",)


def cache_specs_serve(cache_shape: Any, mesh, cfg: ModelConfig) -> Any:
    """Caches: batch over ("pod","data") when divisible, else sequence
    over ("data",...); sequence/state dims over "model"."""
    batch_axes = _batch_axes(mesh)
    bsize = _size(mesh, batch_axes)
    model_size = mesh_lib.axis_sizes(mesh)["model"]

    def batch_entry(b):
        return _entry(batch_axes) if b % bsize == 0 and b >= bsize else None

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"/(k|v)$", path) and len(shape) == 5:
            # [G, B, S, H_kv, Dh]
            _, b, seq, _, _ = shape
            spec = [None] * 5
            spec[1] = batch_entry(b)
            seq_axes: tuple[str, ...] = ("model",)
            if spec[1] is None:
                # B too small: also spread sequence over the batch axes.
                seq_axes = (*batch_axes, "model")
            ssize = _size(mesh, seq_axes)
            if seq % ssize == 0 and seq >= ssize:
                spec[2] = _entry(seq_axes)
            elif seq % model_size == 0:
                spec[2] = "model"
            return P(*spec)
        if re.search(r"/(conv|ssm)$", path) and len(shape) >= 3:
            # mamba states [G, B, c|di, di|ds] — shard the d_inner dim.
            spec = [None] * len(shape)
            di_dim = 2 if path.endswith("ssm") else len(shape) - 1
            if shape[di_dim] % model_size == 0:
                spec[di_dim] = "model"
            spec[1] = batch_entry(shape[1])
            return P(*spec)
        # pos scalars, xlstm states etc.: batch-shard if possible.
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = batch_entry(shape[1])
        return P(*spec)

    return tree_map_with_path(spec_for, cache_shape)


def token_specs_serve(token_shape, mesh) -> P:
    batch_axes = _batch_axes(mesh)
    b = token_shape.shape[0]
    bsize = _size(mesh, batch_axes)
    if b % bsize == 0 and b >= bsize:
        return P(_entry(batch_axes), None)
    return P(None, None)


# ---------------------------------------------------------------------------
# Acting on specs: the calling rank's part of a tree, and back
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _part(leaf, spec: P, mesh, coords: dict[str, int]):
    if len(spec) != len(leaf.shape):
        raise ValueError(f"spec {spec} for a leaf of shape {tuple(leaf.shape)}")
    named = [a for entry in spec for a in _axes_of(entry)]
    for a in named:
        if named.count(a) > 1:
            raise ValueError(f"spec {spec} uses the axis {a!r} twice")
    index = []
    for dim, entry in zip(leaf.shape, spec):
        axes = _axes_of(entry)
        n = _size(mesh, axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {axes} ({n})")
        i = mesh_lib.agent_index(mesh, axes, coords)
        index.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return leaf[tuple(index)]


def fsdp_plan(specs: Any, mesh, axes: tuple[str, ...] = ("data",),
              lead: int = 0) -> Any:
    """Per leaf, the dim (counted after ``lead`` leading dims) that its
    spec splits over one of ``axes`` of size > 1, or None: where no dim
    is, and for an expert leaf split along its experts (the "ep" role),
    which is not gathered but served by its owner."""
    sizes = mesh_lib.axis_sizes(mesh)

    def dim_of(path, spec):
        inner = spec[lead:]
        roles = _rules_for(path) or ()
        for d, entry in enumerate(inner):
            if not any(a in axes and sizes.get(a, 1) > 1
                       for a in _axes_of(entry)):
                continue
            k = len(roles) - (len(inner) - d)
            if 0 <= k < len(roles) and "ep" in roles[k]:
                return None
            return d
        return None

    return tree_map_with_path(dim_of, specs)


def split_over(spec: P, mesh, axes: tuple[str, ...]) -> bool:
    """Whether ``spec`` splits a dim over one of ``axes`` of size > 1."""
    sizes = mesh_lib.axis_sizes(mesh)
    return any(a in axes and sizes.get(a, 1) > 1
               for entry in spec for a in _axes_of(entry))


def shard_tree(tree: Any, specs: Any, mesh,
               coords: dict[str, int] | None = None) -> Any:
    """Each leaf's part at ``coords`` (the calling rank's on a
    ``DeviceMesh`` when None): a view, sliced along every dim whose spec
    entry names axes, with no communication. Leaves may be tensors or
    numpy arrays."""
    coords = mesh_lib.coordinate(mesh) if coords is None else coords
    return tree_map(lambda leaf, spec: _part(leaf, spec, mesh, coords),
                    tree, specs)


def _gathered(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    out = local
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if _size(mesh, axes) > 1:
            out = torch.cat(mesh_lib.all_gather(out, mesh, axes), dim=dim)
    return out


def gather_tree(local: Any, specs: Any, mesh) -> Any:
    """The inverse of ``shard_tree`` on a ``DeviceMesh``: every rank gets
    the whole tree (one ``all_gather`` per sharded dim of each leaf;
    collective, every rank calls it)."""
    return tree_map(lambda leaf, spec: _gathered(leaf, spec, mesh),
                    local, specs)
