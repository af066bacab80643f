"""Opt-in activation sharding hints for mesh-agnostic model code.

Counterpart of the JAX package's ``models/sharding_hints.py``. The
launch layer knows the mesh ("data"/"model"/"pod" axes); the model only
knows logical roles ("batch", "seq", "tp"). ``hints`` installs a
role→axes map for the duration of a ``with`` block; ``constrain(x,
roles)`` is called where the reference pins activations (the group
boundary in ``model.py``, the dispatch buffers in ``moe.py``).

The port's activations are local tensors, with no partitioner to pin
them, so ``constrain`` returns ``x`` itself with or without hints.
``resolve(shape, roles, mesh)`` gives the spec that the reference's
divisibility guard would pin under the installed hints, for tensor
parallelism inside an agent (ROADMAP item A7b) to act on.
"""

from __future__ import annotations

import contextvars

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import P

_HINTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "sharding_hints", default=None
)


class hints:
    """``with hints({"batch": ("data",), "tp": ("model",)}):`` installs
    the role→axes map until the block exits (nested blocks restore the
    outer map)."""

    def __init__(self, role_axes: dict):
        self._role_axes = dict(role_axes)
        self._tokens: list = []

    def __enter__(self):
        self._tokens.append(_HINTS.set(self._role_axes))
        return self

    def __exit__(self, *exc):
        _HINTS.reset(self._tokens.pop())
        return False


def constrain(x, roles: tuple):
    """roles: per-dim role name or None, e.g. ("batch", "seq", None).
    The identity on the port's local tensors."""
    return x


def resolve(shape, roles: tuple, mesh) -> P | None:
    """The spec the reference's ``constrain`` pins for a tensor of
    ``shape`` under the installed hints on ``mesh`` (either kind), or
    None when no hints are installed. Divisibility-guarded: a role is
    dropped if its axes' size is 1 or does not divide the dim."""
    mapping = _HINTS.get()
    if mapping is None:
        return None
    sizes = mesh_lib.axis_sizes(mesh)
    spec = []
    for dim, r in enumerate(roles):
        axes = mapping.get(r) if r else None
        if axes:
            size = 1
            for a in axes:
                size *= sizes.get(a, 1)
            if size <= 1 or shape[dim] % size or shape[dim] < size:
                axes = None
        if not axes:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(tuple(axes))
    return P(*spec)
