"""Checkpoint/restore with atomic writes, retention, async saves.

Counterpart of the JAX package's ``checkpoint/checkpoint.py``, with the
same on-disk layout, so that a state saved by either package restores in
the other: ``<dir>/step_<N>/`` holds ``state.npz`` (one array
``leaf_{i}`` per leaf) and ``manifest.json`` (step, leaf count, the tree's
structure as ``jax.tree`` prints it, dtypes, shapes). Two things keep the
layout the reference's:

* leaf order — ``leaf_{i}`` numbers the leaves in ``jax.tree``'s order,
  which sorts every dict's keys (the port's ``tree`` helpers walk dicts
  in insertion order; this module flattens in JAX's order itself);
* bfloat16 — numpy has no bfloat16, and ``np.savez`` of a JAX bf16 array
  stores its raw 2-byte records (``|V2``). The port writes a bf16 tensor's
  bits the same way and reads a ``|V2`` leaf back as bf16.

The port's state keeps its step counter as a Python int; it is written as
the int32 scalar the reference's state holds, and read back as an int.

Writes go to a temp directory and are atomically renamed, so a crash
mid-save never corrupts the latest checkpoint. ``AsyncCheckpointer`` runs
saves on a background thread (device→host copy now, serialization in the
background), and retention keeps the most recent K checkpoints.

Elastic restore: ``restore(..., num_agents=m)`` re-maps stacked-agent
state between different agent counts (new agents start from agent 0's
replica; dropped agents are discarded).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch import compat

_BF16_ON_DISK = np.dtype("V2")


def _leaves(tree: Any) -> list:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _unflatten(like: Any, it) -> Any:
    """``like``'s structure (dict keys in ``like``'s order) filled from
    ``it`` in ``_leaves`` order."""
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, it) for v in like]
        return type(like)(out) if isinstance(like, tuple) else out
    return next(it)


def _treedef(tree: Any) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` spells it,
    without the ``PyTreeDef(...)`` around it."""
    if isinstance(tree, dict):
        return "{" + ", ".join(
            f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)
        ) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and its manifest dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy()
            return bits.view(_BF16_ON_DISK), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, dtype=np.int32)  # the reference's step
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, state: Any, keep: int = 3) -> str:
    """Synchronous atomic save; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    hosted = [_host(leaf) for leaf in _leaves(state)]
    np.savez(
        os.path.join(tmp, "state.npz"),
        **{f"leaf_{i}": arr for i, (arr, _) in enumerate(hosted)},
    )
    manifest = {
        "step": step,
        "num_leaves": len(hosted),
        "treedef": f"PyTreeDef({_treedef(state)})",
        "time": time.time(),
        "dtypes": [name for _, name in hosted],
        "shapes": [list(arr.shape) for arr, _ in hosted],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(directory, keep)
    return final


def _apply_retention(directory: str, keep: int) -> None:
    ckpts = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, ref: Any, device: torch.device) -> torch.Tensor:
    """A loaded array as a tensor on ``device``; a ``|V2`` leaf is bf16
    bits and needs a bf16 example leaf."""
    if arr.dtype == _BF16_ON_DISK:
        if ref.dtype != torch.bfloat16:
            raise ValueError(
                f"a bfloat16 leaf on disk for a {ref.dtype} example leaf"
            )
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def restore(
    directory: str,
    example_state: Any,
    step: int | None = None,
    num_agents: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[Any, int]:
    """Restore (state, step). ``example_state`` provides the structure
    (tensors — ``meta`` ones will do — and int counters); ``num_agents``
    triggers elastic agent-axis re-mapping; tensor leaves land on
    ``device`` (``None`` means CUDA and raises without a card) with the
    dtype they were saved in."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    dev = compat.resolve_device(device)
    path = os.path.join(directory, f"step_{step:010d}")
    loaded = []
    with np.load(os.path.join(path, "state.npz")) as data:
        for i, ref in enumerate(_leaves(example_state)):
            arr = data[f"leaf_{i}"]
            if isinstance(ref, int):
                loaded.append(int(arr))
                continue
            ref_shape = tuple(ref.shape)
            if (
                num_agents is not None
                and arr.ndim >= 1
                and len(ref_shape) == arr.ndim
                and ref_shape[1:] == arr.shape[1:]
                and ref_shape[0] != arr.shape[0]
            ):
                arr = _remap_agents(arr, ref_shape[0])
            loaded.append(_tensor(arr, ref, dev))
    return _unflatten(example_state, iter(loaded)), step


def _remap_agents(arr: np.ndarray, new_m: int) -> np.ndarray:
    """Elastic agent-axis resize: shrink = truncate; grow = clone agent 0."""
    old_m = arr.shape[0]
    if new_m <= old_m:
        return arr[:new_m]
    extra = np.repeat(arr[:1], new_m - old_m, axis=0)
    return np.concatenate([arr, extra], axis=0)


def _snapshot(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


class AsyncCheckpointer:
    """Non-blocking saves: device→host copy now, disk write in background.

    A failed background save raises from the next ``save``, ``wait`` or
    ``close``.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint"
        )
        self._future: concurrent.futures.Future | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        host_state = _unflatten(
            state, iter([_snapshot(l) for l in _leaves(state)])
        )
        self._future = self._pool.submit(
            save, self.directory, step, host_state, self.keep
        )

    def wait(self) -> None:
        if self._future is not None:
            future, self._future = self._future, None
            future.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
