"""Public entry points of the port's kernels.

Counterpart of the JAX package's ``kernels/ops.py``, without its
``use_pallas`` switch and the TPU block sizes, plus the port's two
recurrent kernels (Mamba's selective scan, sLSTM's recurrence), which the
JAX package leaves to XLA's scans: a CUDA tensor always goes to the
hand-written kernel (or the call raises), a CPU tensor to the plain
version. ``launch_count(name)`` reads one kernel's launch counter,
``reset_launch_count()`` sets every counter to 0. A fake tensor (the dry
run) launches nothing: each kernel module counts such calls apart, and
``fake_flops(name)`` reads the FLOPs they stand for (the module's
``work``); ``reset_fake_calls()`` sets those counts to 0.
"""

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mixing_combine as _mixing
from repro_torch.kernels import selective_scan as _scan
from repro_torch.kernels import slstm_scan as _slstm
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mixing_combine import (
    mixing_sgd_combine,
    mixing_sgd_combine_stacked,
)
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.slstm_scan import slstm_scan

KERNELS = {
    "mixing_sgd_combine": _mixing,
    "flash_attention": _flash,
    "decode_attention": _decode,
    "selective_scan": _scan,
    "slstm_scan": _slstm,
}


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` (a key of ``KERNELS``) since its last reset."""
    return KERNELS[kernel].launch_count()


def fake_flops(kernel: str) -> int:
    """The FLOPs that the calls of ``kernel`` on fake tensors since its
    last reset stand for."""
    return KERNELS[kernel].fake_flops()


def reset_fake_calls() -> None:
    """Set every kernel's fake-call counts to 0."""
    for module in KERNELS.values():
        module.reset_fake_calls()


def reset_launch_count() -> None:
    """Set every kernel's launch counter to 0."""
    for module in KERNELS.values():
        module.reset_launch_count()


__all__ = [
    "KERNELS",
    "decode_attention",
    "fake_flops",
    "flash_attention",
    "launch_count",
    "mixing_sgd_combine",
    "mixing_sgd_combine_stacked",
    "reset_fake_calls",
    "reset_launch_count",
    "selective_scan",
    "slstm_scan",
]
