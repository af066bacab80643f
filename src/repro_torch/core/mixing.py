"""Mixing-matrix algebra (paper §II-D, §III-B) — host numpy.

The port's own copy of the JAX package's ``core/mixing.py`` (which is
numpy as well), bitwise the same: building W from link weights,
validating it, ρ(W) and its subgradient, the in-place Frank-Wolfe step,
and the convergence model K(ρ) of eq. (13).

A valid D-PSGD mixing matrix W is symmetric with every row/column summing
to one (doubly-stochasticity of values in [0,1] is NOT required by the
adopted convergence bound — paper footnote 2). Every such W decomposes as

    W = I − B diag(α) Bᵀ                                  (3)
      = (1 − Σ α_ij) I + Σ α_ij S^(i,j)                   (16, Lemma III.4)

with B the overlay incidence matrix and S^(i,j) the swapping matrices.
The convergence-controlling parameter is ρ(W) = ‖W − J‖ (Theorem III.3);
iterations to ε-stationarity scale as K(ρ) of eq. (13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np


def ideal_matrix(m: int) -> np.ndarray:
    """J = 𝟙𝟙ᵀ/m — one-shot full averaging."""
    return np.full((m, m), 1.0 / m)


def swapping_matrix(m: int, i: int, j: int) -> np.ndarray:
    """S^(i,j): identity with rows/cols i,j swapped — activates link (i,j)."""
    s = np.eye(m)
    s[i, i] = s[j, j] = 0.0
    s[i, j] = s[j, i] = 1.0
    return s


def incidence_matrix(m: int, links: Sequence[tuple[int, int]]) -> np.ndarray:
    """|V|×|E| oriented incidence matrix B (orientation arbitrary)."""
    b = np.zeros((m, len(links)))
    for e, (i, j) in enumerate(links):
        b[i, e] = 1.0
        b[j, e] = -1.0
    return b


def matrix_from_weights(
    m: int, links: Sequence[tuple[int, int]], alpha: Sequence[float]
) -> np.ndarray:
    """W = I − B diag(α) Bᵀ (eq. 3); W_ij = α_ij off-diagonal."""
    alpha = np.asarray(alpha, dtype=np.float64)
    if len(alpha) != len(links):
        raise ValueError("alpha/links length mismatch")
    w = np.eye(m)
    for (i, j), a in zip(links, alpha):
        w[i, j] = w[j, i] = a
        w[i, i] -= a
        w[j, j] -= a
    return w


def weights_from_matrix(w: np.ndarray) -> tuple[list[tuple[int, int]], np.ndarray]:
    """Inverse of ``matrix_from_weights`` on the nonzero support."""
    m = w.shape[0]
    links, alpha = [], []
    for i in range(m):
        for j in range(i + 1, m):
            if abs(w[i, j]) > 1e-12:
                links.append((i, j))
                alpha.append(w[i, j])
    return links, np.asarray(alpha)


def validate_mixing(w: np.ndarray, atol: float = 1e-8) -> None:
    """Check symmetry and unit row/column sums."""
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError("mixing matrix must be square")
    if not np.allclose(w, w.T, atol=atol):
        raise ValueError("mixing matrix must be symmetric")
    ones = np.ones(w.shape[0])
    if not np.allclose(w @ ones, ones, atol=atol):
        raise ValueError("mixing matrix rows must sum to one")


def rho(w: np.ndarray) -> float:
    """ρ(W) = ‖W − J‖ (spectral norm; W−J is symmetric)."""
    m = w.shape[0]
    eigs = np.linalg.eigvalsh(w - ideal_matrix(m))
    return float(np.max(np.abs(eigs)))


def rho_gradient(w: np.ndarray) -> np.ndarray:
    """Subgradient ∇ρ(W) = u_max v_maxᵀ (eq. 18).

    For the symmetric W−J this is sign(λ*)·v* v*ᵀ with (λ*, v*) the
    extreme eigenpair by absolute value.
    """
    return rho_and_gradient(w)[1]


def rho_and_gradient(w: np.ndarray) -> tuple[float, np.ndarray]:
    """(ρ(W), ∇ρ(W)) from a single eigendecomposition.

    Callers that need both per step (the FMMD loop tracks the ρ
    trajectory while following the gradient) would otherwise factor
    W − J twice per iteration — at 500 agents the dominant sweep cost.
    The ρ value may differ from ``rho()`` in the last ulp (LAPACK's
    with-vectors driver vs. values-only). LAPACK's subset drivers
    (dsyevr/dsyevx IL=IU) were evaluated for the extreme pair and
    rejected: on the heavily clustered spectra of early Frank-Wolfe
    iterates they can return an *empty* subset at the degenerate end,
    and on dense-spectrum iterates the saving over dsyevd is <1.3×.
    """
    m = w.shape[0]
    eigs, vecs = np.linalg.eigh(w - ideal_matrix(m))
    k = int(np.argmax(np.abs(eigs)))
    v = vecs[:, k]
    grad = math.copysign(1.0, eigs[k]) * np.outer(v, v)
    return float(np.abs(eigs[k])), grad


def fw_step(
    w: np.ndarray, gamma: float, atom: tuple[int, int] | None
) -> None:
    """In-place Frank-Wolfe update W ← (1−γ)·W + γ·S^(atom).

    Bitwise-identical to forming the atom densely (``swapping_matrix``
    or I) and evaluating ``(1−γ)·W + γ·S`` — without the two O(m²)
    temporaries per step: entries where S is zero see ``(1−γ)·w + γ·0``,
    an exact no-op on the nonnegative FW iterates; the diagonal adds
    ``γ·1`` with the same two flops; and for a swapping atom the
    (i,i)/(j,j) entries are restored to their pure scaled values while
    (i,j)/(j,i) gain γ.
    """
    w *= 1.0 - gamma
    diag = np.einsum("ii->i", w)
    if atom is None:  # identity atom
        diag += gamma
        return
    i, j = atom
    sii, sjj = w[i, i], w[j, j]
    diag += gamma
    w[i, i] = sii
    w[j, j] = sjj
    w[i, j] += gamma
    w[j, i] += gamma


@dataclasses.dataclass(frozen=True)
class ConvergenceConstants:
    """Problem constants of assumptions (1)-(3), Theorem III.3."""

    lipschitz: float = 1.0        # l
    sigma_hat: float = 1.0        # σ̂  (stochastic gradient noise)
    zeta_hat: float = 1.0         # ζ̂  (data heterogeneity)
    m1: float = 0.0               # M1
    m2: float = 0.0               # M2
    f_gap: float = 1.0            # F(x̄¹) − F_inf
    epsilon: float = 1e-2         # target ε-stationarity


def iterations_to_converge(
    rho_value: float, m: int, c: ConvergenceConstants = ConvergenceConstants()
) -> float:
    """K(ρ) of eq. (13), up to the universal constant.

    Increasing in ρ; diverges as ρ → 1. Used to *rank* designs (the
    universal constant cancels in comparisons).
    """
    if not (0.0 <= rho_value):
        raise ValueError("rho must be nonnegative")
    if rho_value >= 1.0:
        return math.inf
    gap = 1.0 - rho_value**2
    eps = c.epsilon
    term1 = c.sigma_hat**2 / (m * eps**2)
    term2 = (
        c.zeta_hat * math.sqrt(c.m1 + 1.0)
        + c.sigma_hat * math.sqrt(gap)
    ) / (gap * eps**1.5)
    term3 = math.sqrt((c.m2 + 1.0) * (c.m1 + 1.0)) / (gap * eps)
    return c.lipschitz * c.f_gap * (term1 + term2 + term3)


def total_time(
    tau: float, rho_value: float, m: int,
    c: ConvergenceConstants = ConvergenceConstants(),
) -> float:
    """Objective (15): per-iteration time × iterations to convergence."""
    return tau * iterations_to_converge(rho_value, m, c)
