"""Device resolution, numerics switches and dtype names for the port.

Importing this module switches TF32 off for matrix products and
convolutions: every path of the port is held against a reference that
asks for full float32 precision (``Precision.HIGHEST`` in the JAX
package's ``core/dpsgd.py``), and TF32 keeps about three decimal digits.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


class NoCudaDeviceError(RuntimeError):
    """``device=None`` (or a CUDA device) was asked for without a card."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA and raises ``NoCudaDeviceError`` without a card.

    There is no quiet CPU path: only an explicit ``device="cpu"`` (what
    the CPU tests pass) resolves to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device: the port runs on the GPU unless the "
                "caller passes device='cpu' explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_of(name: str | torch.dtype) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``…) → ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(
            f"unknown dtype name {name!r}; known: {sorted(_DTYPES)}"
        )
    return _DTYPES[name]
