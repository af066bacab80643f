"""Hand-written Hopper kernels + their plain PyTorch versions.

Entry points in ``repro_torch.kernels.ops``; CUDA C++ sources under
``csrc/``, built at first use by ``repro_torch.kernels.build``.
"""
