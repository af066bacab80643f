"""Parameters across the two packages, key for key.

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

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            if bf16_as_bits:
                return t.contiguous().view(torch.int16).numpy().view(np.uint16)
            return t.to(torch.float32).numpy()
        return t.numpy()

    return convert(params)
