"""Plain PyTorch versions of the port's kernels (the oracle in tests).

Counterpart of the JAX package's ``kernels/ref.py``. Only the mixing
combine is here; the attention oracles arrive with their kernels.
"""

from __future__ import annotations

import torch


def mixing_sgd_combine_ref(
    x: torch.Tensor,
    recv: torch.Tensor,
    weights: torch.Tensor,
    momentum: torch.Tensor,
    *,
    lr: float,
) -> torch.Tensor:
    """``W_ii·x + Σ_r W_{i,j_r}·recv[r] − lr·momentum`` for one agent.

    x ``[N]``, recv ``[R, N]``, weights ``[R+1]``, momentum ``[N]``;
    float32 accumulation, one cast back to ``x.dtype``.
    """
    w = weights.to(torch.float32)
    acc = x.to(torch.float32) * w[0]
    acc = acc + torch.einsum("r,rn->n", w[1:], recv.to(torch.float32))
    acc = acc - lr * momentum.to(torch.float32)
    return acc.to(x.dtype)


def mixing_sgd_combine_stacked_ref(
    x: torch.Tensor,
    idx: torch.Tensor,
    weights: torch.Tensor,
    g: torch.Tensor,
    *,
    lr: float,
) -> torch.Tensor:
    """All agents at once over the stacked axis (eq. (2) of the paper).

    ``out[a] = w[a,0]·x[a] + Σ_r w[a,r+1]·x[idx[a,r]] − lr·g[a]`` with
    x, g ``[A, N]``, idx ``int32[A, R]``, weights ``fp32[A, R+1]``;
    float32 accumulation, one cast back to ``x.dtype``. Returns a new
    tensor; ``x`` is not written.
    """
    w = weights.to(torch.float32)
    acc = x.to(torch.float32) * w[:, 0:1]
    for r in range(idx.shape[1]):
        rows = x.index_select(0, idx[:, r].to(torch.int64))
        acc = acc + rows.to(torch.float32) * w[:, r + 1 : r + 2]
    acc = acc - lr * g.to(torch.float32)
    return acc.to(x.dtype)
