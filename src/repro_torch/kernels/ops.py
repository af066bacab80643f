"""Public entry points of the port's kernels.

Counterpart of the JAX package's ``kernels/ops.py``, without its
``use_pallas`` switch and the TPU block sizes: a CUDA tensor always goes
to the hand-written kernel (or the call raises), a CPU tensor to the
plain version. ``launch_count(name)`` reads one kernel's launch counter,
``reset_launch_count()`` sets every counter to 0.
"""

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mixing_combine as _mixing
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mixing_combine import (
    mixing_sgd_combine,
    mixing_sgd_combine_stacked,
)

KERNELS = {
    "mixing_sgd_combine": _mixing,
    "flash_attention": _flash,
    "decode_attention": _decode,
}


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` (a key of ``KERNELS``) since its last reset."""
    return KERNELS[kernel].launch_count()


def reset_launch_count() -> None:
    """Set every kernel's launch counter to 0."""
    for module in KERNELS.values():
        module.reset_launch_count()


__all__ = [
    "KERNELS",
    "decode_attention",
    "flash_attention",
    "launch_count",
    "mixing_sgd_combine",
    "mixing_sgd_combine_stacked",
    "reset_launch_count",
]
