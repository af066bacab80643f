"""Benchmark topology designs (paper §IV-A3): Clique, Ring, Prim.

Each returns the activated link set; weights are then optimized via (14)
— the paper does the same for fair comparison ("we have used (14) to
optimize the link weights under each design").

The port's own copy of the JAX package's ``core/topology_baselines.py``.
Prim runs ``net.topology.minimum_spanning_tree``, a copy of networkx's
Prim that breaks ties the same way; the weights are optimized on
``device`` (``None`` means CUDA).
"""

from __future__ import annotations

import time

import torch

from repro_torch.core.fmmd import FMMDResult
from repro_torch.core.weight_opt import optimize_weights
from repro_torch.net.topology import (
    Graph,
    OverlayNetwork,
    minimum_spanning_tree,
)


def clique_links(m: int) -> tuple[tuple[int, int], ...]:
    """Activate all overlay links (the baseline the paper beats by >80%)."""
    return tuple((i, j) for i in range(m) for j in range(i + 1, m))


def ring_links(m: int) -> tuple[tuple[int, int], ...]:
    """Ring in agent-index order (common practice)."""
    return tuple(
        (min(i, (i + 1) % m), max(i, (i + 1) % m)) for i in range(m)
    )


def prim_links(overlay: OverlayNetwork) -> tuple[tuple[int, int], ...]:
    """Minimum spanning tree (Prim), proposed by Marfoq et al. [16].

    Edge weight = default-path transfer cost of the overlay link: hop
    count / bottleneck capacity of its underlay routing path (for uniform
    capacities this reduces to hop count, a proxy for contention).
    """
    m = overlay.num_agents
    g = Graph()
    for i, j in overlay.overlay_links:
        edges = overlay.path_edges(i, j)
        bottleneck = min(overlay.underlay.capacity(*e) for e in edges)
        g.add_edge(i, j, weight=len(edges) / bottleneck)
    mst = minimum_spanning_tree(g)
    return tuple(sorted((min(i, j), max(i, j)) for i, j in mst.edges))


def design_from_links(
    m: int,
    links,
    name: str,
    device: str | torch.device | None = None,
) -> FMMDResult:
    """Wrap a fixed topology + (14)-optimized weights as a design result."""
    t0 = time.perf_counter()
    res = optimize_weights(m, links, device=device)
    return FMMDResult(
        matrix=res.matrix,
        activated_links=res.links,
        rho=res.rho,
        rho_trajectory=(res.rho,),
        selected_atoms=(),
        design_seconds=time.perf_counter() - t0,
        variant=name,
    )


def clique_design(
    m: int, device: str | torch.device | None = None
) -> FMMDResult:
    return design_from_links(m, clique_links(m), "Clique", device=device)


def ring_design(
    m: int, device: str | torch.device | None = None
) -> FMMDResult:
    return design_from_links(m, ring_links(m), "Ring", device=device)


def prim_design(
    overlay: OverlayNetwork, device: str | torch.device | None = None
) -> FMMDResult:
    return design_from_links(
        overlay.num_agents, prim_links(overlay), "Prim", device=device
    )
