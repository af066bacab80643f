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

Caches (``model.init_caches`` / the reference's ``M.init_caches``) cross
the same way: ``b{i}_{kind}/{k,v,pos}`` with a leading G axis, K/V in the
compute dtype, ``pos`` int32.
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

    Leaves become ``cfg.param_dtype``. The key set and every shape are
    checked against ``model.init``'s; a mismatch raises ``ValueError``.
    """
    dev = compat.resolve_device(device)
    pdt = compat.dtype_of(cfg.param_dtype)
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

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _leaf_from_numpy(node, pdt, dev)

    return convert(tree)


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

    K/V become ``cfg.compute_dtype``, ``pos`` int32. The keys must be the
    config's ``b{i}_{kind}`` with ``k``, ``v``, ``pos`` each, and the
    shapes ``[G, B, S_cache, KV, Dh]`` / ``[G]``; else ``ValueError``.
    """
    dev = compat.resolve_device(device)
    cdt = compat.dtype_of(cfg.compute_dtype)
    g = cfg.num_groups
    keys = [f"b{i}_{kind}" for i, kind in enumerate(cfg.block_pattern)]
    if sorted(tree) != sorted(keys):
        raise ValueError(f"cache trees differ: {sorted(tree)} vs {keys}")
    out = {}
    for key in keys:
        node = tree[key]
        if sorted(node) != ["k", "pos", "v"]:
            raise ValueError(f"{key}: leaves {sorted(node)}, want k, pos, v")
        k_shape = tuple(np.shape(node["k"]))
        want_tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
        if (
            len(k_shape) != 5 or k_shape[0] != g or k_shape[3:] != want_tail
            or tuple(np.shape(node["v"])) != k_shape
            or tuple(np.shape(node["pos"])) != (g,)
        ):
            raise ValueError(
                f"{key}: k {k_shape}, v {tuple(np.shape(node['v']))}, pos "
                f"{tuple(np.shape(node['pos']))}; want [{g}, B, S, "
                f"{want_tail[0]}, {want_tail[1]}] and [{g}]"
            )
        out[key] = {
            "k": _leaf_from_numpy(node["k"], cdt, dev),
            "v": _leaf_from_numpy(node["v"], cdt, dev),
            "pos": _leaf_from_numpy(
                np.asarray(node["pos"]).astype(np.int32), torch.int32, dev
            ),
        }
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
