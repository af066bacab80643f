"""Link-weight optimization on a fixed support (paper eq. (14)).

    min_α ρ  s.t.  −ρI ⪯ I − B diag(α) Bᵀ − J ⪯ ρI,   α_ij = 0 ∀(i,j) ∉ E_a

Counterpart of the JAX package's ``core/weight_opt.py``. This is an SDP;
with no SDP solver we minimize the (convex, nonsmooth) spectral norm
directly by smoothed spectral minimization: ρ_β(A) = logsumexp(β·|λ(A)|)/β
↓ ρ(A) as β ↑. β is annealed and the exact ρ picks the result. The
smoothed objective and its gradient are torch float64 autograd on
``device`` (``None`` means CUDA); the golden-section polish and the
candidate bookkeeping stay host numpy, as in the reference.

The reference's Adam trajectory is chaotic in the last bit (two starts
1e-15 apart end at different ρ after a few hundred steps), so the port is
held to it step by step (``adam_step`` on the reference's states), not
end to end.

The same machinery, with an optional reweighted-ℓ1 penalty, powers the
SCA baseline (``core/sca.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import mixing


def _matrix_from_alpha(
    alpha: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, m: int
) -> torch.Tensor:
    """Differentiable W(α) = I − B diag(α) Bᵀ on the given support."""
    w = torch.eye(m, dtype=torch.float64, device=alpha.device)
    w = w.index_put((rows, cols), alpha, accumulate=True)
    w = w.index_put((cols, rows), alpha, accumulate=True)
    w = w.index_put((rows, rows), -alpha, accumulate=True)
    w = w.index_put((cols, cols), -alpha, accumulate=True)
    return w


def _abs(alpha: torch.Tensor) -> torch.Tensor:
    """|α| with JAX's subgradient at 0 (+1; torch's ``abs`` gives 0)."""
    return torch.where(alpha >= 0, alpha, -alpha)


def _smoothed_rho(
    alpha: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    m: int,
    beta: float,
    l1: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    w = _matrix_from_alpha(alpha, rows, cols, m)
    a = w - torch.full((m, m), 1.0 / m, dtype=w.dtype, device=w.device)
    eigs = torch.linalg.eigvalsh(a)
    both = torch.cat([eigs, -eigs])  # |λ| via max(λ, −λ) smoothing
    smooth = torch.logsumexp(beta * both, dim=0) / beta
    return smooth + torch.sum(l1 * _abs(alpha))


def adam_step(
    alpha: torch.Tensor,
    mom: torch.Tensor,
    vel: torch.Tensor,
    t: float,
    beta: float,
    rows: torch.Tensor,
    cols: torch.Tensor,
    m: int,
    lr: float,
    l1: torch.Tensor | float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on ``_smoothed_rho``: ``(α, m, v, value)`` after step
    ``t`` (1-based) at smoothing ``beta`` — the reference's jitted ``step``
    (``weight_opt.py:100-110``)."""
    a = alpha.detach().requires_grad_(True)
    val = _smoothed_rho(a, rows, cols, m, beta, l1)
    (g,) = torch.autograd.grad(val, a)
    with torch.no_grad():
        mom = 0.9 * mom + 0.1 * g
        vel = 0.999 * vel + 0.001 * g * g
        mhat = mom / (1.0 - 0.9 ** t)
        vhat = vel / (1.0 - 0.999 ** t)
        alpha = alpha - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return alpha, mom, vel, val.detach()


@dataclasses.dataclass(frozen=True)
class WeightOptResult:
    matrix: np.ndarray
    alpha: np.ndarray
    links: tuple[tuple[int, int], ...]
    rho: float
    iterations: int


def optimize_weights(
    m: int,
    links: Sequence[tuple[int, int]],
    init_alpha: Sequence[float] | None = None,
    steps: int = 800,
    betas: Sequence[float] = (40.0, 160.0, 640.0, 2560.0),
    lr: float = 0.05,
    l1: np.ndarray | float = 0.0,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> WeightOptResult:
    """Solve (14): best symmetric row-stochastic W supported on ``links``.

    Adam on the β-smoothed spectral norm with annealed β, in float64 on
    ``device`` (``None`` means CUDA). ``l1`` adds a (re)weighted-ℓ1
    penalty used by the SCA baseline; 0 reproduces (14). ``seed`` is
    accepted as the reference accepts it (it draws nothing).
    """
    links = tuple((min(i, j), max(i, j)) for i, j in links)
    if len(set(links)) != len(links):
        raise ValueError("duplicate links in support")
    if not links:
        return WeightOptResult(
            matrix=np.eye(m), alpha=np.zeros(0), links=(), rho=mixing.rho(np.eye(m)),
            iterations=0,
        )
    dev = compat.resolve_device(device)
    rows = torch.tensor([i for i, _ in links], dtype=torch.int64, device=dev)
    cols = torch.tensor([j for _, j in links], dtype=torch.int64, device=dev)
    l1_t = (
        float(l1) if np.isscalar(l1)
        else torch.as_tensor(np.asarray(l1, dtype=np.float64), device=dev)
    )
    if init_alpha is None:
        # Degree-normalized local-averaging start (always a valid W).
        deg = np.zeros(m)
        for i, j in links:
            deg[i] += 1
            deg[j] += 1
        a0 = np.array([1.0 / (max(deg[i], deg[j]) + 1.0) for i, j in links])
    else:
        a0 = np.asarray(init_alpha, dtype=np.float64)

    def step(alpha, mom, vel, t, beta):
        return adam_step(alpha, mom, vel, t, beta, rows, cols, m, lr, l1_t)

    def host(alpha) -> np.ndarray:
        return alpha.detach().cpu().numpy()

    alpha = torch.as_tensor(a0, dtype=torch.float64, device=dev)
    mom = torch.zeros_like(alpha)
    vel = torch.zeros_like(alpha)
    best_alpha, best_rho = host(alpha), np.inf
    t = 0
    per_phase = max(1, steps // len(tuple(betas)))
    for beta in betas:
        for _ in range(per_phase):
            t += 1
            alpha, mom, vel, _ = step(alpha, mom, vel, float(t), float(beta))
        cand = host(alpha)
        r = mixing.rho(mixing.matrix_from_weights(m, links, cand))
        if r < best_rho:
            best_rho, best_alpha = r, cand

    # Polish 1: uniform-weight golden-section search (never lose to the
    # best uniform design; exact for symmetric supports like ring/clique).
    if np.isscalar(l1) and float(l1) == 0.0:
        lo_, hi_ = 0.0, 1.0
        invphi = (np.sqrt(5.0) - 1.0) / 2.0
        f = lambda a: mixing.rho(
            mixing.matrix_from_weights(m, links, np.full(len(links), a))
        )
        c_, d_ = hi_ - invphi * (hi_ - lo_), lo_ + invphi * (hi_ - lo_)
        fc, fd = f(c_), f(d_)
        for _ in range(60):
            if fc < fd:
                hi_, d_, fd = d_, c_, fc
                c_ = hi_ - invphi * (hi_ - lo_)
                fc = f(c_)
            else:
                lo_, c_, fc = c_, d_, fd
                d_ = lo_ + invphi * (hi_ - lo_)
                fd = f(d_)
        a_u = (lo_ + hi_) / 2.0
        if f(a_u) < best_rho:
            best_rho = f(a_u)
            best_alpha = np.full(len(links), a_u)
        # Polish 2: restart Adam from the uniform optimum at high β.
        alpha = torch.full(
            (len(links),), a_u, dtype=torch.float64, device=dev
        )
        mom = torch.zeros_like(alpha)
        vel = torch.zeros_like(alpha)
        t2 = 0
        for _ in range(per_phase):
            t2 += 1
            alpha, mom, vel, _ = step(
                alpha, mom, vel, float(t2), float(betas[-1])
            )
        cand = host(alpha)
        r = mixing.rho(mixing.matrix_from_weights(m, links, cand))
        if r < best_rho:
            best_rho, best_alpha = r, cand

    w = mixing.matrix_from_weights(m, links, best_alpha)
    mixing.validate_mixing(w)
    return WeightOptResult(
        matrix=w,
        alpha=best_alpha,
        links=links,
        rho=best_rho,
        iterations=t,
    )
