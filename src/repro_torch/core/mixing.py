"""Mixing-matrix algebra (paper §II-D, §III-B) — host numpy.

The port's own copy of what the D-PSGD trainer needs from the JAX
package's ``core/mixing.py`` (which is numpy as well): building W from
link weights, validating it, and ρ(W). The Frank-Wolfe helpers and the
convergence model arrive with the designer.

A valid D-PSGD mixing matrix W is symmetric with every row/column summing
to one. Every such W decomposes as W = I − B diag(α) Bᵀ (eq. (3)) with B
the overlay incidence matrix; the convergence-controlling parameter is
ρ(W) = ‖W − J‖ (Theorem III.3).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def ideal_matrix(m: int) -> np.ndarray:
    """J = 𝟙𝟙ᵀ/m — one-shot full averaging."""
    return np.full((m, m), 1.0 / m)


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
