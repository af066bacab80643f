"""Communication demands triggered by a set of activated overlay links.

The port's own copy of the JAX package's ``net/demands.py``; it returns
bitwise what the original returns.

Paper eq. (4): instead of 2·|E_a| unicast flows, all flows originating at
the same agent i are combined into one *multicast* flow disseminating
agent i's parameters to its activated neighborhood N_{E_a}(i).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class MulticastDemand:
    """h = (s_h, T_h, κ_h): source agent, destination agents, bytes."""

    source: int
    destinations: frozenset
    size: float

    def __post_init__(self):
        if self.source in self.destinations:
            raise ValueError("source cannot be its own destination")
        if not self.destinations:
            raise ValueError("empty destination set")
        if self.size <= 0:
            raise ValueError("non-positive demand size")


def demands_from_links(
    activated_links: Iterable[tuple[int, int]],
    kappa: float,
    num_agents: int | None = None,
) -> list[MulticastDemand]:
    """Build H (eq. 4) from activated undirected overlay links E_a.

    Every agent with a nonempty activated neighborhood multicasts its
    κ-byte parameter vector to that neighborhood.
    """
    neigh: dict[int, set] = {}
    for i, j in activated_links:
        if i == j:
            raise ValueError("self-link in E_a")
        neigh.setdefault(i, set()).add(j)
        neigh.setdefault(j, set()).add(i)
    if num_agents is not None:
        bad = [a for a in neigh if a >= num_agents or a < 0]
        if bad:
            raise ValueError(f"agent index out of range: {bad}")
    return [
        MulticastDemand(source=i, destinations=frozenset(ns), size=kappa)
        for i, ns in sorted(neigh.items())
        if ns
    ]


def activated_links_from_matrix(w, atol: float = 1e-12) -> list[tuple[int, int]]:
    """E_a(W) = undirected links with nonzero off-diagonal weight."""
    import numpy as np

    w = np.asarray(w)
    m = w.shape[0]
    return [
        (i, j)
        for i in range(m)
        for j in range(i + 1, m)
        if abs(w[i, j]) > atol
    ]
