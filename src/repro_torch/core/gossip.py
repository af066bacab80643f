"""D-PSGD mixing over the stacked agent axis of one card.

Counterpart of the JAX package's ``core/gossip.py``. The mixing step
x_i ← Σ_j W_ij x_j is realized as

  * ``mix_dense``     — einsum with W over the stacked agent axis
    (float32 accumulate): the Clique/J communication pattern. Baseline.
  * ``mix_allreduce`` — exact mean over agents (only valid for W = J).
  * ``mix_sparse``    — ``neighbor_table(w)`` turns W's activated support
    into the index/weight table that the kernel
    ``kernels.ops.mixing_sgd_combine_stacked`` reads, one launch per leaf
    (its form without a gradient term). On one card the agents are dim 0
    of every leaf, so a "receive" is a read of the neighbour's row; both
    multi-device forms of the reference (``mix_sparse_shardmap``,
    ``mix_sparse_flat``) give these values per leaf, and wait for a
    multi-card slice.

``build_schedule`` (pure numpy) returns the identical ``GossipSchedule``
as the JAX package: it is what a multi-device exchange would replay and
what ``gossip_collective_bytes`` prices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """Static point-to-point schedule for a sparse mixing matrix.

    rounds[r]   — tuple of (src_agent, dst_agent) pairs; each agent
                  appears at most once as src and once as dst per round.
    weights[r]  — length-m vector; weights[r][dst] = W[dst, src] for the
                  edge delivered to dst in round r (0 if none).
    self_weight — length-m vector of W[a, a].
    """

    num_agents: int
    rounds: tuple[tuple[tuple[int, int], ...], ...]
    weights: tuple[tuple[float, ...], ...]
    self_weight: tuple[float, ...]


def build_schedule(w: np.ndarray, atol: float = 1e-12) -> GossipSchedule:
    """Greedy edge-coloring of the activated digraph into exchange rounds."""
    w = np.asarray(w, dtype=np.float64)
    m = w.shape[0]
    edges = [
        (src, dst)
        for dst in range(m)
        for src in range(m)
        if src != dst and abs(w[dst, src]) > atol
    ]
    rounds: list[list[tuple[int, int]]] = []
    for e in edges:
        placed = False
        for r in rounds:
            if all(e[0] != f[0] and e[1] != f[1] for f in r):
                r.append(e)
                placed = True
                break
        if not placed:
            rounds.append([e])
    weights = []
    for r in rounds:
        vec = [0.0] * m
        for src, dst in r:
            vec[dst] = float(w[dst, src])
        weights.append(tuple(vec))
    return GossipSchedule(
        num_agents=m,
        rounds=tuple(tuple(r) for r in rounds),
        weights=tuple(weights),
        self_weight=tuple(float(w[a, a]) for a in range(m)),
    )


def neighbor_table(
    w: np.ndarray, atol: float = 1e-12
) -> tuple[np.ndarray, np.ndarray]:
    """W → ``(idx int32[A, R], weights fp32[A, R+1])`` for the stacked kernel.

    Row a lists the agents j ≠ a with ``|W[a, j]| > atol`` in ascending
    order; ``weights[a, 0] = W[a, a]`` and ``weights[a, r+1] =
    W[a, idx[a, r]]``. R is the largest activated in-degree; a padding
    slot has ``idx = a`` and weight 0, so it adds exactly nothing. Every
    index lies in [0, A) by construction — the kernel wrapper relies on it.
    """
    w = np.asarray(w, dtype=np.float64)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError("mixing matrix must be square")
    a_dim = w.shape[0]
    nbrs = [
        [j for j in range(a_dim) if j != a and abs(w[a, j]) > atol]
        for a in range(a_dim)
    ]
    r_max = max((len(n) for n in nbrs), default=0)
    idx = np.repeat(np.arange(a_dim, dtype=np.int32)[:, None], r_max, axis=1)
    weights = np.zeros((a_dim, r_max + 1), dtype=np.float32)
    for a, row in enumerate(nbrs):
        weights[a, 0] = w[a, a]
        for r, j in enumerate(row):
            idx[a, r] = j
            weights[a, r + 1] = w[a, j]
    return np.ascontiguousarray(idx), weights


def mix_dense(params: Any, w: torch.Tensor) -> Any:
    """x_i ← Σ_j W_ij x_j over the leading (stacked) agent axis."""
    return tree_map(
        lambda p: torch.einsum(
            "ab,b...->a...", w.to(torch.float32), p.to(torch.float32)
        ).to(p.dtype),
        params,
    )


def mix_sparse(params: Any, idx: torch.Tensor, weights: torch.Tensor) -> Any:
    """x_i ← Σ_j W_ij x_j over W's support, ``(idx, weights) =
    neighbor_table(W)`` on the parameters' device: one launch of the
    ``mixing_sgd_combine`` kernel per leaf (float32 accumulation over the
    neighbours in ascending order, one rounding to the leaf's dtype)."""

    def leaf(p):
        a = p.shape[0]
        return ops.mixing_sgd_combine_stacked(
            p.reshape(a, -1), idx, weights
        ).reshape(p.shape)

    return tree_map(leaf, params)


def mix_allreduce(params: Any) -> Any:
    """W = J: plain averaging (classic data-parallel all-reduce)."""
    return tree_map(
        lambda p: p.to(torch.float32)
        .mean(dim=0, keepdim=True)
        .expand(p.shape)
        .to(p.dtype),
        params,
    )


def effective_mixing_matrix(w: np.ndarray, rounds: int = 1) -> np.ndarray:
    """W^rounds — the matrix one model update sees under multi-round
    graph gossip (``rounds`` back-to-back exchanges on the same overlay
    before the local step). ρ(Wʳ − J) = ρ(W − J)ʳ, so extra rounds buy
    convergence speed at r× the per-update network price —
    ``priced_training.GossipStrategy`` charges exactly that.
    ``rounds=1`` returns the float64 view of ``w`` (one-shot mixing).
    """
    if rounds < 1:
        raise ValueError(f"gossip rounds must be >= 1: {rounds}")
    w = np.asarray(w, dtype=np.float64)
    return np.linalg.matrix_power(w, rounds) if rounds > 1 else w


def gossip_collective_bytes(
    schedule: GossipSchedule, kappa_bytes: float, gossip_rounds: int = 1
) -> float:
    """Modeled per-iteration gossip traffic (all agents, both directions).

    Each directed activated edge ships κ bytes; compare with clique
    all-gather: m·(m−1)·κ. ``gossip_rounds`` scales the figure for a
    multi-round strategy (the schedule replays per round).
    """
    if gossip_rounds < 1:
        raise ValueError(f"gossip rounds must be >= 1: {gossip_rounds}")
    return (
        kappa_bytes * sum(len(r) for r in schedule.rounds) * gossip_rounds
    )
