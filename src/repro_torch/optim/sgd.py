"""SGD with momentum — the D-PSGD base optimizer. Functional optax-style.

Counterpart of the JAX package's ``optim/sgd.py``, with the same order of
operations and roundings:

    new_m = momentum·m.f32 + g.f32
    new_p = (p.f32 − lr·new_m).to(p.dtype)
    new_m = new_m.to(m.dtype)

Each ``a·b + c`` is one fused multiply-add (``torch.add(c, b, alpha=a)``),
as XLA compiles the reference's two expressions: so the results are
bitwise the reference's in bfloat16 and float32 alike.

It runs leaf by leaf: only one leaf's float32 temporaries are alive at a
time (the reference's ``tree.map`` builds every float32 ``new_m`` at once,
which at Qwen2-0.5B × 8 agents would be 16 GB more). ``lr`` is a Python
float, read on the host: a tensor is refused, since reading it would
synchronise with the device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def host_lr(lr) -> float:
    """``lr`` as the float32 value the reference computes with: a Python
    number, rounded through ``np.float32`` (so ``lr·m`` is the float32
    product, not a double one rounded once)."""
    if isinstance(lr, torch.Tensor):
        raise TypeError(
            "lr must be a Python number read on the host, not a tensor"
        )
    return float(np.float32(lr))


def init(params: Any, momentum_dtype: torch.dtype | None = None) -> dict:
    return {
        "momentum": tree_map(
            lambda p: torch.zeros_like(p, dtype=momentum_dtype or p.dtype),
            params,
        )
    }


def update(
    grads: Any, state: dict, params: Any, lr: float, momentum: float = 0.9
) -> tuple[Any, dict]:
    """Returns ``(new_params, new_state)``; the inputs are not written."""
    lr = host_lr(lr)
    new_p, new_m = [], []
    with torch.no_grad():
        for p, m, g in zip(
            tree_leaves(params), tree_leaves(state["momentum"]),
            tree_leaves(grads),
        ):
            m32 = m.to(torch.float32, copy=True)
            torch.add(g, m32, alpha=momentum, out=m32)
            p32 = torch.sub(p, m32, alpha=lr)
            new_p.append(p32.to(p.dtype))
            new_m.append(m32.to(m.dtype))
            del m32, p32
    return (
        tree_unflatten(params, new_p),
        {"momentum": tree_unflatten(state["momentum"], new_m)},
    )
