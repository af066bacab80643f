"""Gradient/parameter compression — composable with mixing design (§I).

The port's copy of the JAX package's ``runtime/compression.py``. The paper
notes compression, hyperparameter optimization, and adaptive
communication "are compatible with each other and thus can be combined";
κ in the communication optimizer is then the *compressed* size
(footnote 5: use the max compressed size for a guaranteed τ). Provided
operators, all tree-level (nested dicts / lists / tuples of tensors,
``repro_torch.tree``), each leaf compressed on its own device:

  * top-k sparsification (with error feedback accumulator),
  * random-k sparsification (rescaled, unbiased),
  * int8 linear quantization (per-tensor scale).

Each returns (compressed_payload, decode_fn, bytes) so the trainer can
feed real κ values back into the routing/mixing design.

Where the port departs from the reference's calls, not its results:

* ``jax.lax.top_k`` puts the lower index first among equal magnitudes;
  ``torch.topk`` does not promise that on CUDA, so top-k is a stable
  descending sort of ``|flat|`` cut to its first k (a bf16 leaf holds
  many equal magnitudes).
* random-k draws its indices from a ``torch.Generator`` on the leaf's
  device seeded with the reference's integer (``i·7919 + seed``), not
  from ``jax.random.choice``: the chosen coordinates differ, while k, the
  ``1/fraction`` rescale and the byte count are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class Compressed:
    payload: Any
    nbytes: int
    decode: Callable[[], Any]


def _leaf_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _keep(n: int, fraction: float) -> int:
    return max(1, int(n * fraction))


def _scatter(idx: torch.Tensor, vals: torch.Tensor, shape, dtype):
    flat = torch.zeros(shape.numel(), dtype=dtype, device=vals.device)
    flat[idx.long()] = vals.to(dtype)
    return flat.reshape(shape)


def _topk_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest ``|flat|``, the lower index first among
    equal magnitudes (``jax.lax.top_k``'s order)."""
    return torch.sort(flat.abs(), descending=True, stable=True).indices[:k]


def topk_compress(tree: Any, fraction: float = 0.01) -> Compressed:
    """Keep the largest-|value| fraction per leaf: (indices, values)."""
    payload = []
    nbytes = 0
    for leaf in tree_leaves(tree):
        flat = leaf.reshape(-1)
        k = _keep(flat.numel(), fraction)
        idx = _topk_indices(flat, k)
        vals = flat[idx]
        payload.append((idx.to(torch.int32), vals, leaf.shape, leaf.dtype))
        nbytes += k * (4 + leaf.element_size())

    def decode():
        return tree_unflatten(
            tree, [_scatter(*entry) for entry in payload]
        )

    return Compressed(payload, nbytes, decode)


def randk_compress(tree: Any, fraction: float = 0.01, seed: int = 0) -> Compressed:
    """Unbiased random-k: keep random coordinates, scale by 1/fraction."""
    payload = []
    nbytes = 0
    for i, leaf in enumerate(tree_leaves(tree)):
        flat = leaf.reshape(-1)
        k = _keep(flat.numel(), fraction)
        gen = torch.Generator(device=leaf.device).manual_seed(i * 7919 + seed)
        idx = torch.randperm(
            flat.numel(), generator=gen, device=leaf.device
        )[:k]
        vals = flat[idx] / fraction
        payload.append((idx.to(torch.int32), vals, leaf.shape, leaf.dtype))
        nbytes += k * (4 + leaf.element_size())

    def decode():
        return tree_unflatten(
            tree, [_scatter(*entry) for entry in payload]
        )

    return Compressed(payload, nbytes, decode)


def _int8_scale(leaf: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-12) / 127`` in the leaf's own dtype (bf16 for a
    bf16 leaf), as the reference computes it."""
    return torch.clamp_min(leaf.abs().max(), 1e-12) / 127.0


def int8_compress(tree: Any) -> Compressed:
    """Per-tensor symmetric int8 quantization."""
    payload = []
    nbytes = 0
    for leaf in tree_leaves(tree):
        scale = _int8_scale(leaf)
        # float32 / a scale of the leaf's dtype promotes to float32;
        # torch.round is half-to-even, as jnp.round.
        q = torch.clamp(
            torch.round(leaf.to(torch.float32) / scale), -127, 127
        ).to(torch.int8)
        payload.append((q, scale, leaf.dtype))
        nbytes += leaf.numel() + 4

    def decode():
        return tree_unflatten(
            tree,
            [
                (q.to(torch.float32) * scale).to(dtype)
                for q, scale, dtype in payload
            ],
        )

    return Compressed(payload, nbytes, decode)


@dataclasses.dataclass
class ErrorFeedback:
    """EF memory for biased compressors (top-k): compress(g + e)."""

    residual: Any = None

    def step(
        self, grads: Any, compressor: Callable[[Any], Compressed]
    ) -> Compressed:
        if self.residual is None:
            self.residual = tree_map(torch.zeros_like, grads)
        corrected = tree_map(lambda g, e: g + e, grads, self.residual)
        comp = compressor(corrected)
        decoded = comp.decode()
        self.residual = tree_map(lambda c, d: c - d, corrected, decoded)
        return comp


def compressed_kappa(example_tree: Any, method: str, **kw) -> int:
    """Worst-case compressed payload bytes — the κ fed to the designer
    (paper footnote 5)."""
    leaves = tree_leaves(example_tree)
    if method == "topk":
        frac = kw.get("fraction", 0.01)
        return sum(
            _keep(l.numel(), frac) * (4 + l.element_size()) for l in leaves
        )
    if method == "int8":
        return sum(l.numel() + 4 for l in leaves)
    if method == "none":
        return sum(_leaf_bytes(l) for l in leaves)
    raise ValueError(method)
