"""D-PSGD mixing, over the stacked agent axis of one card or across ranks.

Counterpart of the JAX package's ``core/gossip.py``. The mixing step
x_i ← Σ_j W_ij x_j is realized as

  * ``mix_dense``     — einsum with W over the agents (float32
    accumulate): the Clique/J communication pattern. Baseline. With a
    ``mesh`` each rank holds its agent's ``[1, …]`` leaves, gathers every
    agent's over the agent group and keeps its row of W.
  * ``mix_allreduce`` — exact mean over agents (only valid for W = J);
    with a ``mesh``, one all-reduce over the agent group.
  * ``mix_sparse``    — on one card: ``neighbor_table(w)`` turns W's
    activated support into the index/weight table that the kernel
    ``kernels.ops.mixing_sgd_combine_stacked`` reads, one launch per leaf
    (its form without a gradient term); a "receive" is a read of the
    neighbour's row.
  * ``mix_sparse_p2p`` — across ranks, the counterpart of the reference's
    ``mix_sparse_shardmap``: the ``GossipSchedule``'s rounds become
    point-to-point sends and receives posted in one
    ``batch_isend_irecv``, and each rank combines its own shard with what
    it received through ``kernels.ops.mixing_sgd_combine`` (the
    per-agent form without momentum), one launch per leaf. Each agent
    ships κ bytes per activated out-edge.
  * ``mix_sparse_flat`` — across ranks for parameters replicated over
    ``slice_axes`` (the ``data_dp`` layout): the tree raveled to one
    buffer, each replica gossiping only its slice, then gathered.

``build_schedule`` (pure numpy) returns the identical ``GossipSchedule``
as the JAX package: what ``mix_sparse_p2p`` replays and what
``gossip_collective_bytes`` prices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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


def _agents_of(mesh, agent_axes: tuple[str, ...]) -> int:
    sizes = mesh_lib.axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in agent_axes]))


def mix_dense(params: Any, w: torch.Tensor, mesh=None,
              agent_axes: tuple[str, ...] = ("data",)) -> Any:
    """x_i ← Σ_j W_ij x_j over the leading (stacked) agent axis; with a
    ``DeviceMesh``, over the ranks of ``agent_axes`` (leaves ``[1, …]``,
    this rank's agent)."""
    if mesh is None:
        return tree_map(
            lambda p: torch.einsum(
                "ab,b...->a...", w.to(torch.float32), p.to(torch.float32)
            ).to(p.dtype),
            params,
        )
    row = w.to(torch.float32)[mesh_lib.agent_index(mesh, agent_axes)]
    return tree_map(
        lambda p: torch.einsum(
            "b,b...->...", row,
            torch.stack(mesh_lib.all_gather(p[0], mesh, agent_axes))
            .to(torch.float32),
        )[None].to(p.dtype),
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


def mix_allreduce(params: Any, mesh=None,
                  agent_axes: tuple[str, ...] = ("data",)) -> Any:
    """W = J: plain averaging (classic data-parallel all-reduce); with a
    ``DeviceMesh``, one float32 all-reduce per leaf over the ranks of
    ``agent_axes``."""
    if mesh is None:
        return tree_map(
            lambda p: p.to(torch.float32)
            .mean(dim=0, keepdim=True)
            .expand(p.shape)
            .to(p.dtype),
            params,
        )
    m = _agents_of(mesh, agent_axes)
    group = mesh_lib.axis_group(mesh, agent_axes)

    def leaf(p):
        total = p.to(torch.float32, copy=True)
        mesh_lib.group_all_reduce(total, group)
        return (total / m).to(p.dtype)

    return tree_map(leaf, params)


def _exchanges(schedule: GossipSchedule, agent: int):
    """``([dst agents this agent sends to], [(src agent, W[agent, src])…])``
    over the schedule's rounds, in round order."""
    sends, recvs = [], []
    for r, pairs in enumerate(schedule.rounds):
        for src, dst in pairs:
            if src == agent:
                sends.append(dst)
            if dst == agent:
                recvs.append((src, schedule.weights[r][agent]))
    return sends, recvs


def mix_sparse_p2p(
    params: Any,
    schedule: GossipSchedule,
    mesh,
    agent_axes: tuple[str, ...],
) -> Any:
    """Sparse mixing across ranks from the ``GossipSchedule``.

    ``mesh`` is a ``DeviceMesh`` whose ``agent_axes`` form the agent
    space; each leaf of ``params`` is the calling rank's ``[1, …]`` shard.
    For every round in which this rank's agent a is a source it sends its
    shard to the destination's rank; for every round in which it is a
    destination it receives the source's shard into the next row of one
    contiguous ``recv [R_a, N]`` per leaf (R_a: a's in-degree, possibly
    0). All of them go out in one ``batch_isend_irecv`` over the agent
    group. Then one launch of ``mixing_sgd_combine`` per leaf:
    ``W_aa·x + Σ_r W_a,src_r·recv[r]`` with the weights in round order,
    as the reference adds them (float32 accumulation, one rounding to the
    leaf's dtype). A round that skips a is not posted: the reference's
    ppermute delivers zeros with weight 0 there.
    """
    m = schedule.num_agents
    if _agents_of(mesh, agent_axes) != m:
        raise ValueError(
            f"agent axes {agent_axes} hold "
            f"{_agents_of(mesh, agent_axes)} agents, the schedule {m}")
    coords = mesh_lib.coordinate(mesh)
    agent = mesh_lib.agent_index(mesh, agent_axes, coords)
    peers = mesh_lib.axis_ranks(mesh, agent_axes, coords)
    group = mesh_lib.axis_group(mesh, agent_axes)
    sends, recvs = _exchanges(schedule, agent)
    leaves = tree_leaves(params)
    flats = [p.reshape(-1).contiguous() for p in leaves]
    bufs = [
        torch.empty((len(recvs), f.numel()), dtype=f.dtype, device=f.device)
        for f in flats
    ]
    # One message per leaf and directed edge; both ends post the leaves in
    # one order, rounds in round order.
    messages = []
    for f, buf in zip(flats, bufs):
        messages += [("send", f, peers[dst]) for dst in sends]
        messages += [("recv", buf[k], peers[src])
                     for k, (src, _) in enumerate(recvs)]
    mesh_lib.exchange(messages, group)
    weights = torch.tensor(
        [schedule.self_weight[agent]] + [w for _, w in recvs],
        dtype=torch.float32, device=flats[0].device,
    )
    out = [
        ops.mixing_sgd_combine(f, buf, weights).reshape(p.shape)
        for p, f, buf in zip(leaves, flats, bufs)
    ]
    return tree_unflatten(params, out)


def mix_sparse_flat(
    params: Any,
    schedule: GossipSchedule,
    mesh,
    agent_axes: tuple[str, ...],
    slice_axes: tuple[str, ...] = ("model",),
) -> Any:
    """Sparse gossip for parameters REPLICATED over ``slice_axes`` (the
    ``data_dp`` layout), across ranks.

    The calling rank's ``[1, …]`` leaves are raveled into one buffer in
    the wire dtype (the leaves' dtype when they share one, else float32)
    and padded to a multiple of the slice count; this rank gossips only
    its slice (``mix_sparse_p2p``: one combine launch), and the mixed
    slices are gathered over ``slice_axes`` (``all_gather_into_tensor``)
    and unraveled to the leaves' dtypes.
    """
    leaves = tree_leaves(params)
    sizes = mesh_lib.axis_sizes(mesh)
    n_slices = int(np.prod([sizes[a] for a in slice_axes]))
    dtypes = {p.dtype for p in leaves}
    wire = leaves[0].dtype if len(dtypes) == 1 else torch.float32
    flat = torch.cat([p.reshape(-1).to(wire) for p in leaves])
    pad = (-flat.numel()) % n_slices
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunk = flat.numel() // n_slices
    s = mesh_lib.agent_index(mesh, slice_axes)
    mixed = mix_sparse_p2p(
        flat[s * chunk:(s + 1) * chunk][None], schedule, mesh, agent_axes)
    del flat
    # the group's ranks ascend with the index over slice_axes
    gathered = torch.empty((n_slices * chunk,), dtype=wire,
                           device=mixed.device)
    mesh_lib.all_gather_into(gathered, mixed.reshape(-1),
                             mesh_lib.axis_group(mesh, slice_axes))
    out, off = [], 0
    for p in leaves:
        n = p.numel()
        out.append(gathered[off:off + n].reshape(p.shape).to(p.dtype))
        off += n
    return tree_unflatten(params, out)


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
