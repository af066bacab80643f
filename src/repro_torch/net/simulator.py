"""Fluid-level simulation of multicast completion times on the underlay.

The port's own copy of the JAX package's ``net/simulator.py``: the numpy
engines ("batched", "vectorized", "reference") are the same host code and
return bitwise what the original returns; the device engine is "torch"
(``net/torch_engine.py``) where the original has "jax".

Validates Lemma III.1/III.2 numerically: under equal bandwidth sharing at
every underlay link, the makespan for equal-size demands equals

    τ = max_e κ · t_e / C_e .

The simulator is event-driven with max-min fair rate allocation (what TCP
approximates): at each event, remaining flows receive max-min fair rates
given the underlay capacities; the next completion is advanced to. The
multicast flow h completes when its slowest unicast branch finishes; a
branch's traffic occupies every underlay edge of its (possibly relayed)
overlay path.

Three engines share the same event arithmetic:

  * ``engine="batched"`` (default) — water-filling variant that freezes
    all tied bottlenecks per round instead of one; fewer allocation
    rounds and the fastest at 200+ agents, but a different fp drain
    order, so the makespan matches "vectorized" only to rtol=1e-9
    (property-tested at small sizes, nightly-gated at 220 agents by
    ``benchmarks/engine_parity.py``).
  * ``engine="vectorized"`` — precomputes a branch×edge incidence
    matrix once per routing solution and runs progressive filling as
    numpy matrix/mask operations, freezing one bottleneck per round in
    the reference's first-encounter tie-break order — bitwise-identical
    to the reference engine (property-tested).
  * ``engine="reference"``  — the original pure-Python dict loops, kept
    as the ground-truth escape hatch the vectorized engine is
    property-tested against.

The ``Scenario`` layer models operating conditions beyond the paper's
static network: piecewise-constant time-varying link capacities,
background cross-traffic flows, straggling agents (throttled below their
fair share), and agent churn (departures cancel the affected branches).
Scenario timeline breakpoints become simulation events, so allocations
stay piecewise-constant and the fluid model remains exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

from repro_torch.analysis.contracts import maybe_validate
from repro_torch.net.routing import RoutingSolution
from repro_torch.net.topology import OverlayNetwork


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Simulation outcome.

    ``makespan`` is the completion time of the slowest *finished* branch
    (churn-cancelled branches are excluded — they represent exchanges the
    surviving agents renormalize away, not time spent waiting).
    ``flow_completion[h]`` is NaN when flow h cannot report a completion
    time: it still had unfinished branches at loop exit (``max_events``
    truncation — check ``unfinished_branches`` before trusting a run
    that may have been cut short), or *all* of its branches were
    churn-cancelled (nothing was delivered; a finite time always means
    the surviving branches actually finished).
    """

    makespan: float
    flow_completion: tuple[float, ...]  # per multicast demand
    num_events: int
    cancelled_branches: int = 0  # churned away before completing
    unfinished_branches: int = 0  # still active when the loop stopped


# ---------------------------------------------------------------------------
# Scenario layer — time-varying operating conditions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapacityPhase:
    """From ``start`` onward, underlay capacities are ``base × scale``.

    ``scale`` is a global multiplier or a per-edge map keyed by underlay
    edge (either direction; missing edges keep multiplier 1.0). Phases are
    piecewise-constant: the latest phase with ``start <= t`` applies.
    """

    start: float
    scale: float | Mapping[tuple[int, int], float] = 1.0


@dataclasses.dataclass(frozen=True)
class CrossTraffic:
    """Background flow occupying ``rate`` bytes/s on every underlay edge
    of the shortest path ``src → dst`` during [start, stop)."""

    src: int  # underlay node id
    dst: int  # underlay node id
    rate: float  # bytes/s
    start: float = 0.0
    stop: float = math.inf


@dataclasses.dataclass(frozen=True)
class StragglerEvent:
    """Agent ``agent`` is slowed by ``slowdown``× during [start, stop).

    A straggler's endpoint (CPU/NIC) throttles every branch incident to
    it to 1/slowdown of its fair share — the freed capacity is *not*
    redistributed (the bottleneck is the host, not the links)."""

    agent: int  # overlay agent index
    slowdown: float  # >= 1
    start: float = 0.0
    stop: float = math.inf


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """Agent ``agent`` leaves at ``time``; branches on overlay links
    touching it — and all branches of flows it sources — are cancelled."""

    agent: int
    time: float


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Time-varying operating conditions consumed by ``simulate()``.

    The default instance is the paper's static network. ``floor_frac``
    bounds effective capacity from below at ``floor_frac × base`` so
    cross-traffic can congest but never fully dead-lock an edge.
    """

    capacity_phases: tuple[CapacityPhase, ...] = ()
    cross_traffic: tuple[CrossTraffic, ...] = ()
    stragglers: tuple[StragglerEvent, ...] = ()
    churn: tuple[ChurnEvent, ...] = ()
    floor_frac: float = 1e-9

    @property
    def is_trivial(self) -> bool:
        return not (
            self.capacity_phases
            or self.cross_traffic
            or self.stragglers
            or self.churn
        )

    def validate(self) -> None:
        for ph in self.capacity_phases:
            if isinstance(ph.scale, Mapping):
                for edge, f in ph.scale.items():
                    if f <= 0:
                        raise ValueError(
                            f"capacity scale for edge {edge} must be "
                            "positive"
                        )
            elif ph.scale <= 0:
                raise ValueError("capacity scale must be positive")
        for ct in self.cross_traffic:
            if ct.rate < 0 or ct.stop < ct.start:
                raise ValueError(f"invalid cross-traffic window: {ct}")
        for ev in self.stragglers:
            if ev.slowdown < 1.0 or ev.stop < ev.start:
                raise ValueError(f"invalid straggler event: {ev}")
        for c in self.churn:
            if c.time < 0:
                raise ValueError(f"negative churn time: {c}")

    def breakpoints(self) -> tuple[float, ...]:
        """Sorted finite times at which conditions change."""
        ts: set[float] = set()
        for ph in self.capacity_phases:
            ts.add(ph.start)
        for ct in self.cross_traffic:
            ts.add(ct.start)
            if math.isfinite(ct.stop):
                ts.add(ct.stop)
        for ev in self.stragglers:
            ts.add(ev.start)
            if math.isfinite(ev.stop):
                ts.add(ev.stop)
        for c in self.churn:
            ts.add(c.time)
        return tuple(sorted(t for t in ts if t > 0 and math.isfinite(t)))

    def shifted(self, t0: float) -> "Scenario":
        """The conditions as seen by a simulation *starting* at
        wall-clock ``t0`` — the per-round pricing primitive of
        ``repro_torch.core.priced_training``: gossip round k of a training
        run begins at the accumulated wall-clock of rounds 0..k-1, and
        its network time is ``simulate(..., scenario=sc.shifted(t_k))``.

        Capacity phases are piecewise-constant, so the phase active at
        ``t0`` (the latest with ``start <= t0``) becomes the new t=0
        phase and later phases keep their relative offsets. Windowed
        events (cross-traffic, stragglers) are clipped to the remaining
        window; fully elapsed windows drop out. A churn departure at or
        before ``t0`` is absorbing — the agent is already gone — so it
        re-emits at time 0 and keeps cancelling that agent's exchanges
        (redesigning on the survivors, which removes those flows
        outright, is the trainer's job, not the pricer's).
        ``shifted(0.0)`` returns ``self`` unchanged.
        """
        if t0 < 0:
            raise ValueError(f"shift origin must be nonnegative: {t0}")
        if t0 == 0.0:
            return self
        active = None
        phases: list[CapacityPhase] = []
        for ph in sorted(self.capacity_phases, key=lambda p: p.start):
            if ph.start <= t0:
                active = ph
            else:
                phases.append(
                    CapacityPhase(start=ph.start - t0, scale=ph.scale)
                )
        if active is not None:
            phases.insert(0, CapacityPhase(start=0.0, scale=active.scale))
        cross = tuple(
            CrossTraffic(
                src=ct.src, dst=ct.dst, rate=ct.rate,
                start=max(0.0, ct.start - t0), stop=ct.stop - t0,
            )
            for ct in self.cross_traffic
            if ct.stop > t0
        )
        stragglers = tuple(
            StragglerEvent(
                agent=ev.agent, slowdown=ev.slowdown,
                start=max(0.0, ev.start - t0), stop=ev.stop - t0,
            )
            for ev in self.stragglers
            if ev.stop > t0
        )
        churn = tuple(
            ChurnEvent(agent=c.agent, time=max(0.0, c.time - t0))
            for c in self.churn
        )
        return Scenario(
            capacity_phases=tuple(phases),
            cross_traffic=cross,
            stragglers=stragglers,
            churn=churn,
            floor_frac=self.floor_frac,
        )


# ---------------------------------------------------------------------------
# Incidence compilation — done once per routing solution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BranchIncidence:
    """Precomputed branch×edge structure for the vectorized engine.

    Only underlay edges crossed by at least one branch are indexed (others
    can never constrain). ``flat_branch``/``flat_edge`` list every
    (branch, edge) traversal in branch-major path order — the same order
    the reference engine's dict loops encounter them, which pins down
    bottleneck tie-breaking and capacity-subtraction order bit for bit.
    """

    edges: tuple[tuple[int, int], ...]  # directed underlay edges
    edge_index: Mapping[tuple[int, int], int]
    base_capacity: np.ndarray  # [E] float64
    flows: np.ndarray  # [B] flow id per branch
    links: np.ndarray  # [B, 2] overlay endpoints (i, j) per branch
    flat_branch: np.ndarray  # [entries] branch-major, path order
    flat_edge: np.ndarray  # [entries]
    branch_ptr: np.ndarray  # [B+1] CSR slices into flat_edge per branch
    edge_branch: np.ndarray  # [entries] branches sorted by (edge, branch)
    edge_ptr: np.ndarray  # [E+1] CSC slices into edge_branch per edge

    def __post_init__(self):
        # CSR well-formedness contract; no-op unless REPRO_VALIDATE=1
        # (repro_torch.analysis.contracts.validate_branch_incidence).
        maybe_validate(self)

    @property
    def num_branches(self) -> int:
        return self.flows.size

    @property
    def num_edges(self) -> int:
        return self.base_capacity.size

    def edge_counts(self, active: np.ndarray) -> np.ndarray:
        """Active-branch crossings per edge (integer-valued float64)."""
        mask = active[self.flat_branch]
        return np.bincount(
            self.flat_edge[mask], minlength=self.num_edges
        ).astype(np.float64)

    def with_capacities(self, changed: Mapping) -> "BranchIncidence":
        """Patch base capacities of the named directed edges in place of
        a full recompile.

        ``changed`` maps directed underlay edges to new *absolute*
        capacities; edges this incidence never indexes (no branch
        crosses them, so they can never constrain) are ignored. The
        branch×edge structure — the expensive Python half of
        ``compile_incidence`` — is shared untouched; only the [E]
        capacity vector is rebuilt, so the incremental-redesign service
        re-prices an in-flight round under a ``LinkStateChange`` at
        O(changed edges). Runs through ``dataclasses.replace``, so the
        CSR contracts re-validate under ``REPRO_VALIDATE=1``.
        """
        cap = self.base_capacity.copy()
        for e, c in changed.items():
            idx = self.edge_index.get(e)
            if idx is not None:
                if c <= 0:
                    raise ValueError(
                        f"patched capacity for edge {e} must be positive"
                    )
                cap[idx] = float(c)
        return dataclasses.replace(self, base_capacity=cap)


def compile_incidence(
    sol: RoutingSolution,
    overlay: OverlayNetwork,
    branches: Sequence[tuple] | None = None,
) -> BranchIncidence:
    """Build the sparse branch×edge incidence for ``sol`` on ``overlay``.

    ``branches`` (from ``sol.unicast_branches``) may be supplied to avoid
    re-expanding the trees when the caller already holds them.
    """
    if branches is None:
        branches = sol.unicast_branches(overlay)
    edge_index: dict[tuple[int, int], int] = {}
    flat_branch: list[int] = []
    flat_edge: list[int] = []
    flows = np.empty(len(branches), dtype=np.int64)
    links = np.empty((len(branches), 2), dtype=np.int64)
    for b, (h, (i, j), path) in enumerate(branches):
        flows[b] = h
        links[b] = (i, j)
        for e in path:
            idx = edge_index.setdefault(e, len(edge_index))
            flat_branch.append(b)
            flat_edge.append(idx)
    edges = tuple(edge_index)
    caps = np.array(
        [overlay.underlay.capacity(*e) for e in edges], dtype=np.float64
    )
    fb = np.asarray(flat_branch, dtype=np.int64)
    fe = np.asarray(flat_edge, dtype=np.int64)
    order = np.argsort(fe, kind="stable")  # (edge, branch) lexicographic
    return BranchIncidence(
        edges=edges,
        edge_index=edge_index,
        base_capacity=caps,
        flows=flows,
        links=links,
        flat_branch=fb,
        flat_edge=fe,
        branch_ptr=np.searchsorted(fb, np.arange(len(branches) + 1)),
        edge_branch=fb[order],
        edge_ptr=np.searchsorted(fe[order], np.arange(len(edges) + 1)),
    )


# ---------------------------------------------------------------------------
# Vectorized rate allocation
# ---------------------------------------------------------------------------


def _first_encounter_tie_break(
    tied: np.ndarray, unfrozen: np.ndarray, inc: BranchIncidence
) -> int:
    """Among ``tied`` edges, the one an unfrozen branch traverses first
    in branch-major path order (cheap CSC walk for small tie sets)."""
    best_edge = -1
    best_branch = -1
    for e in tied:
        crossers = inc.edge_branch[inc.edge_ptr[e] : inc.edge_ptr[e + 1]]
        live = crossers[unfrozen[crossers]]
        if not live.size:
            continue
        b = int(live[0])  # ascending branch order
        if best_branch < 0 or b < best_branch:
            best_branch, best_edge = b, int(e)
        elif b == best_branch:
            # Same first branch: earlier position within its path wins.
            path = inc.flat_edge[
                inc.branch_ptr[b] : inc.branch_ptr[b + 1]
            ]
            for pe in path:
                if pe == e:
                    best_edge = int(e)
                    break
                if pe == best_edge:
                    break
    return best_edge


def _branch_entries(inc: BranchIncidence, idx: np.ndarray) -> np.ndarray:
    """Edge indices traversed by branches ``idx`` (ascending), in
    branch-major path order — a multi-slice gather without a Python loop."""
    fe, bptr = inc.flat_edge, inc.branch_ptr
    if idx.size == 1:
        b = int(idx[0])
        return fe[bptr[b] : bptr[b + 1]]
    starts = bptr[idx]
    lens = bptr[idx + 1] - starts
    cum = np.concatenate(([0], np.cumsum(lens)[:-1]))
    flat_pos = np.arange(int(lens.sum())) + np.repeat(starts - cum, lens)
    return fe[flat_pos]


def _edge_crossers(inc: BranchIncidence, idx: np.ndarray) -> np.ndarray:
    """Branches crossing edges ``idx`` — the CSC multi-slice gather
    (duplicates retained; the analogue of ``_branch_entries``)."""
    eb, eptr = inc.edge_branch, inc.edge_ptr
    if idx.size == 1:
        e = int(idx[0])
        return eb[eptr[e] : eptr[e + 1]]
    starts = eptr[idx]
    lens = eptr[idx + 1] - starts
    cum = np.concatenate(([0], np.cumsum(lens)[:-1]))
    flat_pos = np.arange(int(lens.sum())) + np.repeat(starts - cum, lens)
    return eb[flat_pos]


def _maxmin_rates_vec(
    active: np.ndarray,
    inc: BranchIncidence,
    caps: np.ndarray,
    counts: np.ndarray | None = None,
) -> np.ndarray:
    """Progressive-filling max-min fair rates, as matrix/mask operations.

    Bitwise-identical to ``_maxmin_rates``: the bottleneck each round is
    the first minimum-share edge in branch-major traversal order (the
    reference's dict insertion order), and capacity is drained with
    ``np.subtract.at`` — an unbuffered sequential subtraction matching
    the reference's per-branch loop.

    ``counts`` (active-branch crossings per edge, integer-valued floats)
    may be supplied by a caller that maintains it incrementally; it is
    not mutated.
    """
    n = inc.num_branches
    rates = np.zeros(n)
    unfrozen = active.copy()
    n_unfrozen = int(active.sum())
    cap_left = caps.astype(np.float64, copy=True)
    # Integer-valued float counts, then incremental decrements as
    # branches freeze (each loop turn touches only the entries of newly
    # frozen branches, not the whole structure).
    if counts is None:
        counts = inc.edge_counts(unfrozen)
    else:
        counts = counts.copy()
    share = np.empty(inc.num_edges)
    valid = np.empty(inc.num_edges, dtype=bool)
    fe = inc.flat_edge
    while n_unfrozen:
        np.greater(counts, 0, out=valid)
        share.fill(np.inf)
        np.divide(cap_left, counts, out=share, where=valid)
        e_star = int(np.argmin(share))
        smin = share[e_star]
        if not np.isfinite(smin):
            break  # no edge carries an unfrozen branch
        ties = share == smin  # invalid edges hold inf, never tie
        n_ties = int(np.count_nonzero(ties))
        if n_ties > 1:
            # Tie-break: the first (branch-major, path-order) traversal
            # of any tied edge by an unfrozen branch — the reference's
            # dict-insertion first-encounter order.
            if n_ties <= 8:
                e_star = _first_encounter_tie_break(
                    np.flatnonzero(ties), unfrozen, inc
                )
            else:
                sel = unfrozen[inc.flat_branch] & ties[fe]
                e_star = int(fe[int(np.argmax(sel))])
        crossers = inc.edge_branch[
            inc.edge_ptr[e_star] : inc.edge_ptr[e_star + 1]
        ]
        idx = crossers[unfrozen[crossers]]  # ascending branch order
        rates[idx] = smin
        unfrozen[idx] = False
        n_unfrozen -= idx.size
        touched = _branch_entries(inc, idx)
        # Unbuffered sequential subtraction — bitwise-matches the
        # reference's per-branch capacity drain.
        np.subtract.at(cap_left, touched, smin)
        np.subtract.at(counts, touched, 1.0)
    return rates


def _maxmin_rates_batched(
    active: np.ndarray,
    inc: BranchIncidence,
    caps: np.ndarray,
    counts: np.ndarray | None = None,
) -> np.ndarray:
    """Batched water-filling: freeze *all* tied bottlenecks per round.

    Where ``_maxmin_rates_vec`` drains one bottleneck edge per loop turn
    (replaying the reference's first-encounter tie-break), this engine
    freezes the crossers of every edge achieving the minimum share in a
    single round — fewer loop turns on instances with many symmetric
    bottlenecks (uniform-capacity meshes freeze in O(#distinct shares)
    rounds instead of O(#edges)). The capacity drain is grouped
    differently, so results match the default engine only up to fp
    tolerance (makespan parity is property-tested at rtol=1e-9); hence
    opt-in via ``simulate(engine="batched")`` rather than the default.
    """
    n = inc.num_branches
    rates = np.zeros(n)
    unfrozen = active.copy()
    n_unfrozen = int(active.sum())
    cap_left = caps.astype(np.float64, copy=True)
    if counts is None:
        counts = inc.edge_counts(unfrozen)
    else:
        counts = counts.copy()
    share = np.empty(inc.num_edges)
    valid = np.empty(inc.num_edges, dtype=bool)
    while n_unfrozen:
        np.greater(counts, 0, out=valid)
        share.fill(np.inf)
        np.divide(cap_left, counts, out=share, where=valid)
        smin = share.min()
        if not np.isfinite(smin):
            break  # no edge carries an unfrozen branch
        tied = share == smin
        # Every unfrozen crosser of a tied edge, via CSC slices of just
        # those edges (a full entry-array scan per round would dominate
        # at 200+ agents).
        crossers = _edge_crossers(inc, np.flatnonzero(tied))
        idx = np.unique(crossers[unfrozen[crossers]])
        rates[idx] = smin
        unfrozen[idx] = False
        n_unfrozen -= idx.size
        touched = _branch_entries(inc, idx)
        np.subtract.at(cap_left, touched, smin)
        np.subtract.at(counts, touched, 1.0)
    return rates


def _equal_share_rates_vec(
    active: np.ndarray,
    inc: BranchIncidence,
    caps: np.ndarray,
    counts: np.ndarray | None = None,
) -> np.ndarray:
    """Static equal sharing: every edge splits capacity evenly among its
    crossing branches; a branch gets its min share along the path
    (the allocation of Lemma III.1's achievability argument)."""
    if counts is None:
        counts = inc.edge_counts(active)
    rates = np.full(inc.num_branches, np.inf)
    mask = active[inc.flat_branch]
    fb = inc.flat_branch[mask]
    fe = inc.flat_edge[mask]
    np.minimum.at(rates, fb, caps[fe] / counts[fe])
    rates[~active] = 0.0
    return rates


# ---------------------------------------------------------------------------
# Reference rate allocation (the original dict-loop implementation)
# ---------------------------------------------------------------------------


def _maxmin_rates(
    active: Sequence[int],
    branch_edges: Sequence[tuple[tuple[int, int], ...]],
    capacity: Mapping[tuple[int, int], float],
) -> np.ndarray:
    """Progressive-filling max-min fair rates for the active branches."""
    n = len(active)
    rates = np.zeros(n)
    frozen = np.zeros(n, dtype=bool)
    cap_left = dict(capacity)
    # Count active branches per edge.
    while not frozen.all():
        counts: dict[tuple[int, int], int] = {}
        for a in range(n):
            if frozen[a]:
                continue
            for e in branch_edges[active[a]]:
                counts[e] = counts.get(e, 0) + 1
        # Bottleneck edge: smallest fair share among remaining capacity.
        share, bottleneck = math.inf, None
        for e, cnt in counts.items():
            s = cap_left[e] / cnt
            if s < share:
                share, bottleneck = s, e
        if bottleneck is None:
            break
        # Freeze all unfrozen branches crossing the bottleneck at `share`.
        for a in range(n):
            if frozen[a]:
                continue
            if bottleneck in branch_edges[active[a]]:
                rates[a] = share
                frozen[a] = True
                for e in branch_edges[active[a]]:
                    cap_left[e] -= share
    return rates


def _equal_share_rates(
    active: Sequence[int],
    branch_edges: Sequence[tuple[tuple[int, int], ...]],
    capacity: Mapping[tuple[int, int], float],
) -> np.ndarray:
    """Static equal sharing (reference implementation)."""
    counts: dict[tuple[int, int], int] = {}
    for a in active:
        for e in branch_edges[a]:
            counts[e] = counts.get(e, 0) + 1
    rates = np.empty(len(active))
    for idx, a in enumerate(active):
        rates[idx] = min(capacity[e] / counts[e] for e in branch_edges[a])
    return rates


# ---------------------------------------------------------------------------
# Event loops
# ---------------------------------------------------------------------------


def _simulate_reference(
    sol: RoutingSolution,
    overlay: OverlayNetwork,
    branches: Sequence[tuple[int, tuple[int, int], tuple]],
    fairness: str,
    max_events: int,
) -> SimResult:
    capacity = overlay.underlay.directed_capacities()
    n = len(branches)
    # float64 explicitly: integer demand sizes would otherwise make
    # `remaining[active] -= rates * dt` silently truncate.
    remaining = np.array(
        [sol.demands[h].size for h, _, _ in branches], dtype=np.float64
    )
    done_time = np.full(n, np.nan)
    branch_edges = [edges for _, _, edges in branches]
    t = 0.0
    events = 0
    alloc = _maxmin_rates if fairness == "maxmin" else _equal_share_rates

    active = [a for a in range(n)]
    while active and events < max_events:
        rates = alloc(active, branch_edges, capacity)
        if not np.any(rates > 0):
            raise RuntimeError("starved branches; invalid routing/capacities")
        dt = np.min(remaining[active] / np.maximum(rates, 1e-300))
        t += dt
        remaining[active] -= rates * dt
        still = []
        for idx, a in enumerate(active):
            if remaining[a] <= 1e-9 * sol.demands[branches[a][0]].size:
                done_time[a] = t
            else:
                still.append(a)
        active = still
        events += 1

    return _collect_result(
        sol, np.asarray([h for h, _, _ in branches]), done_time,
        cancelled=np.zeros(n, dtype=bool), events=events,
        unfinished=len(active),
    )


def _phase_capacity_array(
    inc: BranchIncidence, phase: CapacityPhase
) -> np.ndarray:
    """Effective capacities under one phase (precomputed per phase)."""
    if isinstance(phase.scale, Mapping):
        factors = np.ones(inc.num_edges)
        for idx, (u, v) in enumerate(inc.edges):
            f = phase.scale.get((u, v), phase.scale.get((v, u), 1.0))
            factors[idx] = float(f)
        return inc.base_capacity * factors
    return inc.base_capacity * float(phase.scale)


def _branch_keys(inc: BranchIncidence) -> list[tuple[int, int, int]]:
    """(flow, overlay i, overlay j) identity per branch — stable across
    re-routed incidences, so a phase swap can carry each branch's
    remaining volume to the same branch in the next segment's trees."""
    return [
        (h, i, j)
        for h, (i, j) in zip(inc.flows.tolist(), inc.links.tolist())
    ]


@dataclasses.dataclass(frozen=True)
class CarryoverState:
    """Realized per-branch transfer state at one instant of a run.

    The observed-state snapshot an *online* re-router decides from at a
    phase boundary (``carryover_state``): ``remaining[(h, i, j)]`` is
    the volume still in flight on flow h's overlay link (i, j) —
    abandoning that link costs a restart from full κ; ``done`` maps
    finished branches to their finish times; ``cancelled`` holds
    churn-cancelled branch keys; ``flow_done[h]`` is flow h's completion
    time (NaN while unfinished); ``departed`` lists agents that have
    churned away by ``time``.
    """

    time: float
    remaining: Mapping[tuple[int, int, int], float]
    done: Mapping[tuple[int, int, int], float]
    cancelled: frozenset
    flow_done: tuple[float, ...]
    departed: tuple[int, ...]


def _simulate_vectorized(
    sol: RoutingSolution,
    overlay: OverlayNetwork,
    inc: BranchIncidence,
    fairness: str,
    max_events: int,
    scenario: Scenario | None,
    batched: bool = False,
    segments: Sequence[tuple[float, RoutingSolution, BranchIncidence]]
    | None = None,
    stop_time: float = math.inf,
    state_out: dict | None = None,
) -> SimResult:
    """Event loop, optionally swapping the active ``BranchIncidence``.

    ``segments`` (from ``simulate_phased``) lists ``(start, solution,
    incidence)`` per routing segment, first entry starting at 0.0. At a
    boundary the loop folds per-branch state out by (flow, overlay-link)
    key and back into the next segment's branch order: a branch whose
    link survives the re-route keeps its remaining volume (and its
    finish time once done), a branch on a fresh link starts with the
    flow's full κ, and branches of already-complete flows or departed
    agents never reactivate — so the phased makespan is exact under the
    same fluid model. Without ``segments`` this is the single-incidence
    loop unchanged.

    ``stop_time`` halts the run at that instant (landing on it exactly,
    like a phase breakpoint); with ``state_out`` the per-branch state at
    loop exit is folded out by branch key into the supplied dict
    (``remaining``/``done``/``cancelled``/``flow_done``/``departed``/
    ``time``) — how ``carryover_state`` snapshots a prefix of a run for
    the online re-router. A finite ``stop_time`` truncates the returned
    ``SimResult`` (in-flight branches count as unfinished).
    """
    if segments is None:
        segments = ((0.0, sol, inc),)
    n_seg = len(segments)
    H = len(sol.demands)
    # float64 explicitly (see _simulate_reference).
    flow_size = np.array([d.size for d in sol.demands], dtype=np.float64)
    if fairness == "maxmin":
        alloc = _maxmin_rates_batched if batched else _maxmin_rates_vec
    else:
        alloc = _equal_share_rates_vec

    if scenario is not None:
        scenario.validate()
        m = overlay.num_agents
        for ev in (*scenario.stragglers, *scenario.churn):
            if not 0 <= ev.agent < m:
                raise ValueError(
                    f"scenario references agent {ev.agent}, but the "
                    f"overlay has {m} agents"
                )
        phases = tuple(
            sorted(scenario.capacity_phases, key=lambda p: p.start)
        )
        churn = sorted(scenario.churn, key=lambda c: c.time)
        breakpoints = scenario.breakpoints()
    else:
        phases, churn, breakpoints = (), [], ()
    flow_source = np.array([d.source for d in sol.demands], dtype=np.int64)

    # Cross-segment state, keyed by branch identity (phased runs only).
    remaining_map: dict[tuple[int, int, int], float] = {}
    done_map: dict[tuple[int, int, int], float] = {}
    cancelled_keys: set[tuple[int, int, int]] = set()
    flow_done = np.full(H, np.nan)  # completion time once a flow finishes
    departed: list[int] = []  # churned agents already applied
    scen_prep: dict[int, tuple] = {}  # per-incidence scenario arrays

    t = 0.0
    events = 0
    churn_ptr = 0
    bp_ptr = 0
    phase_ptr = 0
    cur_phase = -1  # latest phase with start <= t (t is monotone)

    for si in range(n_seg):
        if segments[si][0] >= stop_time:
            break  # segments at/after the stop instant never start
        seg_start, seg_sol, seg_inc = segments[si]
        seg_end = segments[si + 1][0] if si + 1 < n_seg else math.inf
        # If the previous segment drained (or churned) empty before its
        # end, nothing happens until this segment's re-route takes
        # effect — its fresh branches start transmitting at seg_start.
        if t < seg_start:
            t = seg_start
        n = seg_inc.num_branches
        sizes = flow_size[seg_inc.flows]
        thresh = 1e-9 * sizes
        if si == 0:
            remaining = sizes.copy()
            done_time = np.full(n, np.nan)
            cancelled = np.zeros(n, dtype=bool)
        else:
            # Fold carried state into this segment's branch order.
            keys = _branch_keys(seg_inc)
            remaining = np.array(
                [remaining_map.get(k, s) for k, s in zip(keys, sizes)]
            )
            done_time = np.array([done_map.get(k, np.nan) for k in keys])
            cancelled = np.fromiter(
                (k in cancelled_keys for k in keys), dtype=bool, count=n
            )
            # Already-complete flows carry no fresh work into new links.
            fresh = np.isnan(done_time) & ~cancelled
            fd = flow_done[seg_inc.flows]
            settle = fresh & ~np.isnan(fd)
            done_time[settle] = fd[settle]
            # Agents that already left cancel their fresh branches too.
            for agent in departed:
                hit = np.isnan(done_time) & ~cancelled & (
                    (seg_inc.links[:, 0] == agent)
                    | (seg_inc.links[:, 1] == agent)
                    | (flow_source[seg_inc.flows] == agent)
                )
                cancelled |= hit
        active = np.isnan(done_time) & ~cancelled
        # Active-branch crossings per edge, maintained incrementally as
        # branches finish or churn away (one bincount per segment).
        counts = seg_inc.edge_counts(active)

        if scenario is not None:
            cached = scen_prep.get(id(seg_inc))
            if cached is None:
                # One effective-capacity array per phase, built once per
                # distinct incidence (the swap guard makes segments
                # sharing one incidence the common case; a per-edge
                # Mapping scale would otherwise cost an O(E) Python
                # loop per segment).
                phase_caps = [
                    _phase_capacity_array(seg_inc, ph) for ph in phases
                ]
                # Cross-traffic paths resolved to indexed edges once.
                cross: list[tuple[CrossTraffic, np.ndarray]] = []
                for ct in scenario.cross_traffic:
                    path = overlay.underlay.shortest_path(ct.src, ct.dst)
                    idxs = [
                        seg_inc.edge_index[e]
                        for k in range(len(path) - 1)
                        if (e := (path[k], path[k + 1]))
                        in seg_inc.edge_index
                    ]
                    cross.append((ct, np.asarray(idxs, dtype=np.int64)))
                scen_prep[id(seg_inc)] = (phase_caps, cross)
            else:
                phase_caps, cross = cached
        else:
            phase_caps, cross = [], []

        def drop_counts(
            gone: np.ndarray, inc=seg_inc, counts=counts
        ) -> None:
            idx = np.flatnonzero(gone)
            if idx.size:
                np.subtract.at(counts, _branch_entries(inc, idx), 1.0)

        while (
            active.any() and events < max_events
            and t < seg_end and t < stop_time
        ):
            # Apply departures due by now: cancel branches on overlay
            # links touching the agent and all branches of flows it
            # sources.
            while churn_ptr < len(churn) and churn[churn_ptr].time <= t:
                agent = churn[churn_ptr].agent
                departed.append(agent)
                hit = active & (
                    (seg_inc.links[:, 0] == agent)
                    | (seg_inc.links[:, 1] == agent)
                    | (flow_source[seg_inc.flows] == agent)
                )
                cancelled |= hit
                active &= ~hit
                drop_counts(hit)
                churn_ptr += 1
            if not active.any():
                break

            if scenario is None:
                caps = seg_inc.base_capacity
            else:
                while (
                    phase_ptr < len(phases)
                    and phases[phase_ptr].start <= t
                ):
                    cur_phase = phase_ptr
                    phase_ptr += 1
                caps = (
                    phase_caps[cur_phase] if cur_phase >= 0
                    else seg_inc.base_capacity
                )
                if cross:
                    caps = caps.copy()
                    for ct, idxs in cross:
                        if ct.start <= t < ct.stop and idxs.size:
                            caps[idxs] -= ct.rate
                    np.maximum(
                        caps, scenario.floor_frac * seg_inc.base_capacity,
                        out=caps,
                    )

            rates = alloc(active, seg_inc, caps, counts)
            if scenario is not None and scenario.stragglers:
                factor = np.ones(n)
                for ev in scenario.stragglers:
                    if ev.start <= t < ev.stop:
                        hit = (seg_inc.links[:, 0] == ev.agent) | (
                            seg_inc.links[:, 1] == ev.agent
                        )
                        np.maximum(
                            factor, np.where(hit, ev.slowdown, 1.0),
                            out=factor,
                        )
                rates = rates / factor

            while bp_ptr < len(breakpoints) and breakpoints[bp_ptr] <= t:
                bp_ptr += 1
            t_next = (
                breakpoints[bp_ptr] if bp_ptr < len(breakpoints)
                else math.inf
            )
            eff_end = seg_end if seg_end < stop_time else stop_time
            if eff_end < t_next:
                t_next = eff_end  # boundary/stop instant acts as an event

            if not np.any(rates > 0):
                if math.isinf(t_next):
                    raise RuntimeError(
                        "starved branches; invalid routing/capacities"
                    )
                t = t_next  # conditions may recover at the next breakpoint
                events += 1
                continue

            dt = np.min(
                remaining[active] / np.maximum(rates[active], 1e-300)
            )
            if t_next - t < dt:
                dt = t_next - t
                t = t_next  # land exactly on the breakpoint (no fp drift)
            else:
                t += dt
            remaining[active] -= rates[active] * dt
            finished = active & (remaining <= thresh)
            done_time[finished] = t
            active &= ~finished
            drop_counts(finished)
            events += 1

        if n_seg > 1 or state_out is not None:
            # Fold this segment's state out by branch key. The map is
            # rebuilt from scratch: a key absent from this segment's
            # trees was abandoned by the re-route, and its partial
            # progress is lost for good — a later segment restoring the
            # link restarts it from full κ ("mid-flight data on
            # abandoned links is lost", not parked).
            keys = _branch_keys(seg_inc)
            remaining_map = {}
            for b, k in enumerate(keys):
                if cancelled[b]:
                    cancelled_keys.add(k)
                elif not np.isnan(done_time[b]):
                    done_map[k] = float(done_time[b])
                else:
                    remaining_map[k] = float(remaining[b])
            seg_flows = seg_inc.flows
            for h in range(H):
                if np.isnan(flow_done[h]):
                    selm = seg_flows == h
                    if selm.any() and not (active & selm).any():
                        vals = done_time[selm & ~cancelled]
                        if vals.size and not np.isnan(vals).any():
                            flow_done[h] = float(np.max(vals))
        if (
            events >= max_events or t >= stop_time
            or (n_seg == 1 and not active.any())
        ):
            break
        # Multi-segment runs fall through even when this segment's
        # active set churned/drained empty: a later re-route can add
        # fresh branches (links avoiding the departed agents) that still
        # deliver for unfinished flows.

    if state_out is not None:
        state_out.update(
            time=t,
            remaining=dict(remaining_map),
            done=dict(done_map),
            cancelled=set(cancelled_keys),
            flow_done=flow_done.copy(),
            departed=list(departed),
        )
    result = _collect_result(
        sol, seg_inc.flows, done_time, cancelled, events,
        unfinished=int(active.sum()),
    )
    if n_seg > 1:
        # Union accounting across segments: a key cancelled in any
        # segment counts once, and branches that finished before a
        # later re-route dropped their link still count toward the
        # makespan and their flow's completion time (their data WAS
        # delivered; only the final segment's branches are visible to
        # _collect_result). A flow keeps NaN only while it still has
        # active branches (unfinished) or never finished any branch —
        # NOT when churn cancelled its final-segment branches after an
        # earlier segment already delivered some.
        best: dict[int, float] = {}
        for (h, _, _), t_done in done_map.items():  # ⊇ final-segment dones
            if t_done > best.get(h, -math.inf):
                best[h] = t_done
        fc = list(result.flow_completion)
        flows_final = seg_inc.flows
        for h in range(H):
            if h in best and not bool((active & (flows_final == h)).any()):
                fc[h] = best[h]
        result = dataclasses.replace(
            result,
            makespan=max([result.makespan, *done_map.values()]),
            flow_completion=tuple(fc),
            cancelled_branches=len(cancelled_keys),
        )
    return result


def _collect_result(
    sol: RoutingSolution,
    flows: np.ndarray,
    done_time: np.ndarray,
    cancelled: np.ndarray,
    events: int,
    unfinished: int,
) -> SimResult:
    """Fold per-branch finish times into a ``SimResult``.

    ``flow_completion[h]`` is NaN when flow h cannot report a completion
    time: either a branch was still unfinished at loop exit, or *every*
    branch of the flow was churn-cancelled (the flow delivered nothing —
    distinguishable from "finished instantly", which reports a finite
    time).
    """
    counted = done_time[~cancelled]
    finished_any = bool(np.any(~np.isnan(counted))) if counted.size else False
    flow_completion = []
    for h in range(len(sol.demands)):
        sel = (flows == h) & ~cancelled
        vals = done_time[sel]
        # All branches cancelled -> NaN, not 0.0: "nothing delivered"
        # must not read as "finished instantly".
        flow_completion.append(
            float(np.max(vals)) if vals.size else math.nan
        )
    return SimResult(
        makespan=float(np.nanmax(counted)) if finished_any else 0.0,
        flow_completion=tuple(flow_completion),
        num_events=events,
        cancelled_branches=int(cancelled.sum()),
        unfinished_branches=unfinished,
    )


# Every engine ``simulate``/``simulate_phased`` dispatch on. Keep the
# unknown-engine error below in sync when adding one.
_ENGINES = ("batched", "vectorized", "reference", "torch")


def simulate(
    sol: RoutingSolution,
    overlay: OverlayNetwork,
    fairness: str = "maxmin",
    max_events: int = 100_000,
    scenario: Scenario | None = None,
    engine: str = "batched",
    incidence: BranchIncidence | None = None,
    device=None,
) -> SimResult:
    """Simulate completion of all multicast demands under ``sol``.

    fairness: "maxmin" (TCP-like, dynamic reallocation on completions) or
    "equal" (static equal split, re-evaluated on completions).
    scenario: optional time-varying conditions (vectorized engines only).
    engine: "batched" (default — water-filling that freezes all tied
    bottlenecks per round; fastest at 200+ agents, nightly-gated to
    rtol=1e-9 makespan parity by ``benchmarks/engine_parity.py``),
    "vectorized" (one bottleneck per round, replaying the reference
    tie-break order — bitwise-identical to "reference",
    property-tested), "reference" (original dict loops, the
    scenario-free pure-Python escape hatch), or "torch" (the batched
    water-filling on the device in float64 torch ops —
    ``net/torch_engine.py``; maxmin fairness with capacity phases +
    churn, rtol=1e-9 against "batched"; its real payoff is whole
    stochastic rollout batches via
    ``torch_engine.simulate_rollout_batch``).
    device: where engine="torch" runs — ``None`` means CUDA (and raises
    without a card), ``"cpu"`` runs it here; the numpy engines ignore
    it.
    incidence: a precompiled ``BranchIncidence`` for ``sol`` over
    ``overlay`` (possibly capacity-patched via ``with_capacities``),
    skipping branch enumeration + ``compile_incidence`` — the design
    service's repeated-transition-pricing fast path. The caller owns
    the claim that it matches ``sol``/``overlay``.

    Engine / scenario / stochastic matrix::

        engine=       scenario=                     stochastic realizations
        ------------  ----------------------------  -------------------------
        "batched"     full (capacity phases,        host loop: simulate each
                      cross-traffic, stragglers,    ``sample_many()`` draw as
                      churn)                        its ``scenario=``
        "vectorized"  full (same as "batched")      same host loop
        "reference"   RAISES on any scenario;       unsupported
                      RAISES on a precompiled
                      ``incidence=``
        "torch"       capacity phases + churn;      one device pass for the
                      RAISES on cross-traffic or    whole batch via
                      straggler events              ``torch_engine.
                                                    rollout_batch_results``
                                                    (see ``StochasticTau.
                                                    price`` /
                                                    ``evaluate_design``)
    """
    if fairness not in ("maxmin", "equal"):
        raise ValueError(f"unknown fairness {fairness!r}")
    if engine not in _ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}: valid engines are 'batched' "
            "(default numpy water-filling), 'vectorized' (one "
            "bottleneck per round, bitwise-matches 'reference'), "
            "'reference' (pure-Python escape hatch), and 'torch' "
            "(device batching)"
        )
    if incidence is not None and engine == "reference":
        raise ValueError(
            "a precompiled incidence requires a vectorized engine"
        )
    for h, (demand, tree) in enumerate(zip(sol.demands, sol.trees)):
        if not tree:
            raise ValueError(
                f"demand {h} (source {demand.source}) has an empty routing "
                "tree; route it before simulating"
            )
    if scenario is not None and scenario.is_trivial:
        scenario = None
    if engine == "torch":
        # Deferred import: the numpy engines must stay importable (and
        # fast to import) without touching torch.
        from repro_torch.net.torch_engine import simulate_torch

        return simulate_torch(
            sol, overlay, fairness=fairness, max_events=max_events,
            scenario=scenario, incidence=incidence, device=device,
        )
    if incidence is not None:
        if incidence.num_branches == 0:
            return SimResult(0.0, tuple(0.0 for _ in sol.demands), 0)
        return _simulate_vectorized(
            sol, overlay, incidence, fairness, max_events, scenario,
            batched=(engine == "batched"),
        )
    branches = sol.unicast_branches(overlay)
    if not branches:
        return SimResult(0.0, tuple(0.0 for _ in sol.demands), 0)
    if engine == "reference":
        if scenario is not None:
            raise ValueError(
                "scenarios require the vectorized engine "
                "(engine='vectorized')"
            )
        return _simulate_reference(
            sol, overlay, branches, fairness, max_events
        )
    inc = compile_incidence(sol, overlay, branches)
    return _simulate_vectorized(
        sol, overlay, inc, fairness, max_events, scenario,
        batched=(engine == "batched"),
    )


def simulate_phased(
    phased,
    overlay: OverlayNetwork,
    fairness: str = "maxmin",
    max_events: int = 100_000,
    scenario: Scenario | None = None,
    engine: str = "batched",
    device=None,
) -> SimResult:
    """Simulate a ``PhasedRoutingSolution`` (time-expanded routing).

    Each segment's trees are compiled to a ``BranchIncidence`` (one per
    distinct tree set — segments sharing a solution share the compiled
    incidence), and the vectorized event loop swaps the active incidence
    at each boundary, carrying every branch's remaining volume across
    the swap by (flow, overlay-link) identity. ``scenario`` supplies the
    capacity phases/cross-traffic/stragglers/churn exactly as in
    ``simulate`` — pass the same scenario the schedule was routed for.
    A single-segment schedule reduces to ``simulate(phased.solutions[0],
    ...)``; one whose segments share a tree matches the single-incidence
    makespan (property-tested at rtol=1e-9). Engines: "vectorized",
    "batched", or "torch" (the reference engine has no incidence to
    swap). "torch" lowers the segment schedule to a loop over
    per-phase capacity vectors on the device (``device=``, as in
    ``simulate``); it requires every segment
    to share one tree set (the swap guard's common case — volume
    carryover across an actual re-route is host-side).

    Engine / scenario / stochastic matrix::

        engine=       scenario=                     stochastic realizations
        ------------  ----------------------------  -------------------------
        "batched"     full; segments may re-route   host loop over
                      at boundaries (volume         ``sample_many()`` draws
                      carryover)
        "vectorized"  full (same as "batched")      same host loop
        "reference"   RAISES always (no incidence   unsupported
                      to swap)
        "torch"       capacity phases + churn;      via ``StochasticTau.
                      RAISES on cross-traffic /     price(engine="torch")``
                      stragglers and on schedules   (static schedule only)
                      that re-route at a boundary
                      (price those with "batched")
    """
    if fairness not in ("maxmin", "equal"):
        raise ValueError(f"unknown fairness {fairness!r}")
    if engine not in ("vectorized", "batched", "torch"):
        raise ValueError(
            "phased simulation requires an incidence-swapping engine "
            "('vectorized', 'batched', or 'torch')"
        )
    for sol in phased.solutions:
        for h, (demand, tree) in enumerate(zip(sol.demands, sol.trees)):
            if not tree:
                raise ValueError(
                    f"demand {h} (source {demand.source}) has an empty "
                    "routing tree; route it before simulating"
                )
    base = phased.solutions[0]
    if not base.demands:
        return SimResult(0.0, (), 0)
    if scenario is not None and scenario.is_trivial:
        scenario = None
    compiled: dict[tuple, BranchIncidence] = {}
    segments = []
    for start, sol in zip(phased.boundaries, phased.solutions):
        inc = compiled.get(sol.trees)
        if inc is None:
            inc = compile_incidence(sol, overlay)
            compiled[sol.trees] = inc
        segments.append((start, sol, inc))
    if engine == "torch":
        if len(compiled) != 1:
            raise ValueError(
                "engine='torch' prices phased schedules whose segments "
                "all share one tree set (segment boundaries become "
                "device-side capacity-vector swaps); this schedule "
                "re-routes at a boundary, which needs the host loop's "
                "volume carryover — price it with engine='batched'"
            )
        from repro_torch.net.torch_engine import simulate_torch

        return simulate_torch(
            base, overlay, fairness=fairness, max_events=max_events,
            scenario=scenario, incidence=segments[0][2],
            extra_boundaries=tuple(float(b) for b in phased.boundaries),
            device=device,
        )
    return _simulate_vectorized(
        base, overlay, segments[0][2], fairness, max_events, scenario,
        batched=(engine == "batched"), segments=tuple(segments),
    )


def carryover_state(
    phased,
    overlay: OverlayNetwork,
    stop_time: float,
    fairness: str = "maxmin",
    max_events: int = 100_000,
    scenario: Scenario | None = None,
    engine: str = "batched",
) -> CarryoverState:
    """Snapshot the realized per-branch state of a phased run at an
    instant — what an online re-router is allowed to observe.

    Runs ``simulate_phased``'s event loop on ``phased`` (segments at or
    after ``stop_time`` never start) and halts exactly at ``stop_time``,
    folding every branch's state out by (flow, overlay-link) key. The
    scenario may extend past ``stop_time``: the loop only ever applies
    conditions with ``start <= t``, so the snapshot contains no
    lookahead — future phases cannot leak into it. A churn event at
    exactly ``stop_time`` belongs to the next segment and is *not*
    applied.
    """
    if fairness not in ("maxmin", "equal"):
        raise ValueError(f"unknown fairness {fairness!r}")
    if engine not in ("vectorized", "batched"):
        raise ValueError(
            "carryover snapshots require a vectorized engine "
            "('vectorized' or 'batched')"
        )
    if not math.isfinite(stop_time) or stop_time < 0:
        raise ValueError(f"stop_time must be finite and >= 0: {stop_time}")
    base = phased.solutions[0]
    if stop_time <= phased.boundaries[0]:
        # Nothing has run yet: every branch is fresh, no flow finished.
        return CarryoverState(
            time=float(stop_time), remaining={}, done={},
            cancelled=frozenset(),
            flow_done=tuple(math.nan for _ in base.demands),
            departed=(),
        )
    if scenario is not None and scenario.is_trivial:
        scenario = None
    compiled: dict[tuple, BranchIncidence] = {}
    segments = []
    for start, sol in zip(phased.boundaries, phased.solutions):
        inc = compiled.get(sol.trees)
        if inc is None:
            inc = compile_incidence(sol, overlay)
            compiled[sol.trees] = inc
        segments.append((start, sol, inc))
    state: dict = {}
    _simulate_vectorized(
        base, overlay, segments[0][2], fairness, max_events, scenario,
        batched=(engine == "batched"), segments=tuple(segments),
        stop_time=stop_time, state_out=state,
    )
    return CarryoverState(
        time=float(state["time"]),
        remaining=state["remaining"],
        done=state["done"],
        cancelled=frozenset(state["cancelled"]),
        flow_done=tuple(float(x) for x in state["flow_done"]),
        departed=tuple(state["departed"]),
    )


def per_edge_loads(
    sol: RoutingSolution, overlay: OverlayNetwork
) -> dict[tuple[int, int], int]:
    """t_e per directed underlay edge (eq. 6) — for Lemma III.1 checks."""
    loads: dict[tuple[int, int], int] = {}
    for h, tree in enumerate(sol.trees):
        for (i, j) in tree:
            for e in overlay.path_edges(i, j):
                loads[e] = loads.get(e, 0) + 1
    return loads


def lemma31_time(
    sol: RoutingSolution, overlay: OverlayNetwork, kappa: float
) -> float:
    """Closed-form τ = max_e κ t_e / C_e from link-level knowledge (eq. 7)."""
    loads = per_edge_loads(sol, overlay)
    return max(
        (
            kappa * t / overlay.underlay.capacity(*e)
            for e, t in loads.items()
        ),
        default=0.0,
    )
