"""Public entry points of the port's kernels.

Counterpart of the JAX package's ``kernels/ops.py``, without its
``use_pallas`` switch: a CUDA tensor always goes to the hand-written
kernel (or the call raises), a CPU tensor to the plain version.
"""

from repro_torch.kernels.mixing_combine import (
    launch_count,
    mixing_sgd_combine,
    mixing_sgd_combine_stacked,
    reset_launch_count,
)

__all__ = [
    "launch_count",
    "mixing_sgd_combine",
    "mixing_sgd_combine_stacked",
    "reset_launch_count",
]
