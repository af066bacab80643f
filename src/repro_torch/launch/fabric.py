"""A cluster's interconnect as the paper's underlay (hardware adaptation).

Counterpart of the JAX package's ``launch/fabric.py``. Agents occupy rows
of the (data, model) mesh; a gossip exchange (i, j) moves each agent's
parameters along the ring of the ``data`` axis. The per-model-column
paths are identical, so the whole fabric reduces to ONE ring underlay of
``agents_per_pod`` nodes whose links carry the gossip traffic of all
model columns in parallel. Multi-pod runs add a second ring, each node
joined to its peer in the next pod by a slower cross-pod link — the
bandwidth-limited regime where underlay-aware design matters most.

The two bandwidths are arguments (bytes/s per direction): the fabric is
the caller's, and the port quotes no figure for it.

``design_mixing_matrix`` runs the paper's full pipeline (categories →
FMMD-WP → weight opt) against this fabric and returns the W that
``launch.train.build_train_artifacts`` takes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.fmmd import fmmd_wp
from repro_torch.net.categories import compute_categories
from repro_torch.net.topology import Graph, Underlay, build_overlay


def ring_fabric_underlay(
    agents_per_pod: int, pods: int = 1, *, link_bw: float,
    cross_pod_bw: float,
) -> Underlay:
    """Ring(s) of agent nodes (``link_bw``); cross-pod peers joined by
    ``cross_pod_bw`` links."""
    g = Graph()
    for p in range(pods):
        base = p * agents_per_pod
        for i in range(agents_per_pod):
            g.add_edge(
                base + i,
                base + (i + 1) % agents_per_pod,
                capacity=link_bw,
            )
    for i in range(agents_per_pod):
        for p in range(pods - 1):
            g.add_edge(
                p * agents_per_pod + i,
                (p + 1) * agents_per_pod + i,
                capacity=cross_pod_bw,
            )
    if pods == 1 and agents_per_pod == 2:
        # path_graph degenerate double-edge guard: ring of 2 = single link
        g = Graph()
        g.add_edge(0, 1, capacity=link_bw)
    return Underlay(graph=g)


@functools.lru_cache(maxsize=16)
def design_mixing_matrix(
    num_agents: int,
    pods: int = 1,
    kappa_bytes: float = 1e9,
    iterations: int | None = None,
    *,
    link_bw: float,
    cross_pod_bw: float,
    device: str | torch.device | None = None,
) -> tuple:
    """FMMD-WP on the fabric underlay. Returns (W, design) — cached.

    κ is the per-agent gossip payload (the parameter bytes actually
    shipped per exchange). The weight optimization runs on ``device``
    (``None`` means CUDA and raises without a card).
    """
    per_pod = num_agents // pods
    if num_agents == 1:
        return (np.ones((1, 1)), None)
    underlay = ring_fabric_underlay(
        per_pod, pods, link_bw=link_bw, cross_pod_bw=cross_pod_bw
    )
    overlay = build_overlay(underlay, list(range(num_agents)))
    cats = compute_categories(overlay)
    t = iterations or max(2 * num_agents, 4)
    design = fmmd_wp(num_agents, t, cats, kappa_bytes, device=device)
    return (design.matrix, design)
