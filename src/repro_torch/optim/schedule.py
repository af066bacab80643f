"""Learning-rate schedules (paper §IV-A1 uses step decay: 0.1 / 0.05 / 0.01).

Counterpart of the JAX package's ``optim/schedule.py``. Each schedule is a
function of the host's step counter that returns a Python float: the
float32 value the ``jnp`` version returns (every value is rounded through
``np.float32``, and ``cosine`` is computed in float32 with numpy). The
kernels take the rate by value, so it is never a device tensor and reading
it never synchronises.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def constant(lr: float):
    value = float(_F32(lr))
    return lambda step: value


def step_decay(boundaries_values):
    """Piecewise-constant: [(boundary_step, value), ...] sorted ascending.

    ``paper_schedule`` below reproduces the paper's 0.1/0.05/0.01 decay.
    """
    bounds = [b for b, _ in boundaries_values]
    vals = [float(_F32(v)) for _, v in boundaries_values]

    def fn(step: int) -> float:
        lr = vals[-1]
        for b, v in reversed(list(zip(bounds, vals))):
            if step < b:
                lr = v
        return lr

    return fn


def paper_schedule(steps_per_epoch: int):
    """0.1 for 30 epochs, 0.05 for 30, 0.01 after (paper §IV-A1)."""
    return step_decay(
        [(30 * steps_per_epoch, 0.1), (60 * steps_per_epoch, 0.05), (10**9, 0.01)]
    )


def cosine(base_lr: float, total_steps: int, warmup: int = 0):
    def fn(step: int) -> float:
        s = _F32(step)
        warm = min(s / _F32(max(warmup, 1)), _F32(1.0))
        prog = np.clip(
            (s - _F32(warmup)) / _F32(max(total_steps - warmup, 1)),
            _F32(0.0), _F32(1.0),
        )
        # cos of the float32 angle, correctly rounded to float32 (through
        # float64), as XLA's float32 cos gives it; numpy's float32 cos
        # parts from it in the last bit, which 1 + cos near -1 magnifies.
        c = _F32(np.cos(np.float64(_F32(np.pi) * prog)))
        lr = _F32(base_lr) * warm * _F32(0.5)
        return float(lr * (_F32(1.0) + c))

    return fn
