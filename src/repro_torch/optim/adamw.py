"""AdamW for the non-D-PSGD training paths (examples, ablations).

Counterpart of the JAX package's ``optim/adamw.py``. The step counter
``count`` is a Python int on the host; the bias corrections ``1 − b^t``
are computed from it in float32, as the reference computes them. Leaf by
leaf, like ``optim.sgd``; ``lr`` is a Python float.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim.sgd import host_lr
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init(params: Any, dtype: torch.dtype = torch.float32) -> dict:
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params),
        "count": 0,
    }


def update(
    grads: Any, state: dict, params: Any, lr: float,
    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[Any, dict]:
    """Returns ``(new_params, new_state)``; the inputs are not written."""
    lr = host_lr(lr)
    count = state["count"] + 1
    t = np.float32(count)
    c1 = float(np.float32(1) - np.float32(b1) ** t)
    c2 = float(np.float32(1) - np.float32(b2) ** t)
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for p, m_, v_, g in zip(
            tree_leaves(params), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(grads),
        ):
            gm = g.to(m_.dtype)
            m = b1 * m_ + (1 - b1) * gm
            v = b2 * v_ + (1 - b2) * torch.square(g.to(v_.dtype))
            mh = m / c1
            vh = v / c2
            step = lr * (
                mh / (torch.sqrt(vh) + eps)
                + weight_decay * p.to(mh.dtype)
            )
            new_p.append((p.to(torch.float32) - step).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
            del gm, mh, vh, step
    return (
        tree_unflatten(params, new_p),
        {
            "m": tree_unflatten(state["m"], new_m),
            "v": tree_unflatten(state["v"], new_v),
            "count": count,
        },
    )
