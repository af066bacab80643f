"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Same sub-package and module names as the JAX package so a reader finds
the counterpart of every function; plain functions on dicts of tensors
inside. The port imports ``torch`` and ``numpy`` only — never ``jax``,
``networkx`` or anything of ``repro``.

Every entry point takes ``device=None`` meaning CUDA and raises when
there is no card; only an explicit ``device="cpu"`` runs on the CPU.
"""

from repro_torch import compat  # noqa: F401  (switches TF32 off)

__all__ = ["compat"]
