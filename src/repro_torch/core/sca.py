"""SCA baseline — successive convex approximation topology design.

Reconstruction of the state-of-the-art heuristic from [18] (Huang, Sun,
He, MobiHoc'24), which this paper's FMMD matches in training performance
at lower design cost. [18] sparsifies the mixing matrix by successively
solving convex approximations of the ℓ0-regularized spectral objective.

We implement the standard reweighted-ℓ1 SCA scheme: iterate

    α^(t+1) = argmin_α  ρ_β(W(α)) + λ Σ_ij  |α_ij| / (|α^(t)_ij| + δ)

(each subproblem convex in α given the weights — solved by the same
smoothed spectral machinery as (14)), pruning links whose weight falls
below tolerance. λ sweeps a sparsity frontier; the design minimizing the
estimated total time τ̄(W)·K(ρ(W)) is returned — the same objective (15)
FMMD targets.

The port's own copy of the JAX package's ``core/sca.py``: the sweep, the
pruning and the pick are host code; every weight optimization runs on
``device`` (``None`` means CUDA).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import mixing
from repro_torch.core.fmmd import FMMDResult, _tau_bar
from repro_torch.core.weight_opt import optimize_weights
from repro_torch.net.categories import Categories


def sca_design(
    m: int,
    categories: Categories,
    kappa: float,
    constants: mixing.ConvergenceConstants = mixing.ConvergenceConstants(),
    lambdas: tuple[float, ...] = (0.05, 0.15, 0.4, 1.0, 2.5),
    sca_rounds: int = 3,
    prune_tol: float = 5e-3,
    opt_steps: int = 300,
    device: str | torch.device | None = None,
) -> FMMDResult:
    """Run the SCA sparsification sweep and pick the best total-time design."""
    t0 = time.perf_counter()
    all_links = [(i, j) for i in range(m) for j in range(i + 1, m)]

    best: tuple[float, FMMDResult] | None = None
    for lam in lambdas:
        links = list(all_links)
        alpha = None
        for _ in range(sca_rounds):
            if not links:
                break
            # Reweighted-ℓ1 coefficients from the previous iterate.
            if alpha is None:
                weights = np.full(len(links), lam)
            else:
                weights = lam / (np.abs(alpha) + 1e-2)
            res = optimize_weights(
                m, links, init_alpha=alpha, l1=weights, steps=opt_steps,
                device=device,
            )
            # Prune near-zero links (the SCA sparsification step).
            keep = [
                (l, a)
                for l, a in zip(res.links, res.alpha)
                if abs(a) > prune_tol
            ]
            if not keep:
                links, alpha = [], None
                break
            links = [l for l, _ in keep]
            alpha = np.array([a for _, a in keep])
        if not links:
            continue
        # Final clean weight optimization on the chosen support (14).
        res = optimize_weights(m, links, steps=opt_steps, device=device)
        links_nz, _ = mixing.weights_from_matrix(res.matrix)
        tau = _tau_bar(frozenset(links_nz), categories, kappa)
        total = mixing.total_time(tau, res.rho, m, constants)
        cand = FMMDResult(
            matrix=res.matrix,
            activated_links=tuple(links_nz),
            rho=res.rho,
            rho_trajectory=(res.rho,),
            selected_atoms=(),
            design_seconds=0.0,
            variant="SCA",
        )
        if best is None or total < best[0]:
            best = (total, cand)

    if best is None:
        raise RuntimeError("SCA produced no feasible design")
    result = best[1]
    return FMMDResult(
        matrix=result.matrix,
        activated_links=result.activated_links,
        rho=result.rho,
        rho_trajectory=result.rho_trajectory,
        selected_atoms=(),
        design_seconds=time.perf_counter() - t0,
        variant="SCA",
    )
