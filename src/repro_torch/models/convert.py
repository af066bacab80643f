"""Parameters and decode caches across the two packages, key for key.

The JAX package's ``models.model.init`` and the port's build the same
nested dict (``embed/table``, ``final_norm/scale``, ``blocks/b{i}_{kind}/
…`` with a leading G axis on every block leaf), but initial random bits
cannot match across frameworks. Parity therefore always goes through
this module: the JAX tree crosses as a tree of **numpy arrays**.

How bfloat16 crosses: numpy has no bfloat16, so a bf16 leaf is handed
over either as ``float32`` (exact: every bf16 value is a float32) or as
its raw ``uint16`` bits; an ``ml_dtypes`` bfloat16 array is accepted too
and read through its bits. ``params_to_jax`` emits float32 by default and
``uint16`` bits with ``bf16_as_bits=True``.

Every leaf crosses in the dtype ``model.init`` gives it: the config's
``param_dtype``, except Mamba's ``mixer/a_log``, float32 in any model.

Caches (``model.init_caches`` / the reference's ``M.init_caches``) cross
the same way, with a leading G axis: an attention block's
``b{i}_{kind}/{k,v,pos}`` (K/V in the compute dtype, ``pos`` int32), a
Mamba block's ``conv`` (compute dtype) and ``ssm``, an mLSTM block's ``c``,
``n``, ``m`` and an sLSTM block's ``c``, ``n``, ``h``, ``m`` (float32;
``m`` is −inf before the first token).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model
from repro_torch.tree import tree_paths


def _leaf_from_numpy(arr: Any, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device=device, dtype=dtype)


def params_from_jax(
    tree: dict, cfg: ModelConfig, device: str | torch.device | None = None
) -> dict:
    """JAX parameter tree (numpy leaves) → the port's dict on ``device``.

    Leaves take ``model.init``'s dtypes. The key set and every shape are
    checked against ``model.init``'s; a mismatch raises ``ValueError``.
    """
    dev = compat.resolve_device(device)
    want = dict(tree_paths(model.init(cfg, 0, device="meta")))
    got = dict(tree_paths(tree))
    if want.keys() != got.keys():
        missing = sorted(want.keys() - got.keys())
        extra = sorted(got.keys() - want.keys())
        raise ValueError(
            f"parameter trees differ: missing {missing}, unexpected {extra}"
        )
    for path, ref in want.items():
        if tuple(np.shape(got[path])) != tuple(ref.shape):
            raise ValueError(
                f"{path}: shape {tuple(np.shape(got[path]))} != "
                f"{tuple(ref.shape)}"
            )

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, f"{path}{k}/") for k, v in node.items()}
        return _leaf_from_numpy(node, want[path[:-1]].dtype, dev)

    return convert(tree, "")


def params_to_jax(params: dict, bf16_as_bits: bool = False) -> dict:
    """The port's dict → a tree of numpy arrays with the same keys.

    float32 leaves stay float32; bf16 leaves become float32 (exact) or,
    with ``bf16_as_bits``, their ``uint16`` bits.
    """
    return _to_numpy(params, bf16_as_bits)


def caches_from_jax(
    tree: dict, cfg: ModelConfig, device: str | torch.device | None = None
) -> dict:
    """JAX cache tree (numpy leaves) → the port's caches on ``device``.

    Leaves take ``model.init_caches``' dtypes. The keys must be the
    config's ``b{i}_{kind}``, each with its kind's leaves; K/V must be
    ``[G, B, S_cache, KV, Dh]`` and every other leaf ``init_caches``' shape
    for that batch; else ``ValueError``.
    """
    dev = compat.resolve_device(device)
    keys = [f"b{i}_{kind}" for i, kind in enumerate(cfg.block_pattern)]
    if sorted(tree) != sorted(keys):
        raise ValueError(f"cache trees differ: {sorted(tree)} vs {keys}")
    batch = next(np.shape(leaf)[1] for _, leaf in tree_paths(tree)
                 if np.ndim(leaf) >= 2)
    want = model.init_caches(cfg, batch, 1, "meta")
    g = cfg.num_groups
    out = {}
    for key in keys:
        node, ref = tree[key], want[key]
        if sorted(node) != sorted(ref):
            raise ValueError(
                f"{key}: leaves {sorted(node)}, want {', '.join(sorted(ref))}")
        if "k" in ref:
            k_shape = tuple(np.shape(node["k"]))
            want_tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
            if (
                len(k_shape) != 5 or k_shape[0] != g
                or k_shape[3:] != want_tail
                or tuple(np.shape(node["v"])) != k_shape
                or tuple(np.shape(node["pos"])) != (g,)
            ):
                raise ValueError(
                    f"{key}: k {k_shape}, v {tuple(np.shape(node['v']))}, "
                    f"pos {tuple(np.shape(node['pos']))}; want [{g}, B, S, "
                    f"{want_tail[0]}, {want_tail[1]}] and [{g}]"
                )
        else:
            for leaf, t in ref.items():
                if tuple(np.shape(node[leaf])) != tuple(t.shape):
                    raise ValueError(
                        f"{key}/{leaf}: shape {tuple(np.shape(node[leaf]))}"
                        f" != {tuple(t.shape)}")
        out[key] = {leaf: _leaf_from_numpy(node[leaf], t.dtype, dev)
                    for leaf, t in ref.items()}
    return out


def caches_to_jax(caches: dict, bf16_as_bits: bool = False) -> dict:
    """The port's caches → a tree of numpy arrays with the same keys (bf16
    K/V as in ``params_to_jax``, ``pos`` int32)."""
    return _to_numpy(caches, bf16_as_bits)


def _to_numpy(tree: dict, bf16_as_bits: bool) -> dict:
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            if bf16_as_bits:
                return t.contiguous().view(torch.int16).numpy().view(np.uint16)
            return t.to(torch.float32).numpy()
        return t.numpy()

    return convert(tree)
