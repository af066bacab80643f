"""Overlay routing: minimize per-iteration communication time (paper §III-A).

The port's own copy of the JAX package's ``net/routing.py``; it returns
bitwise what the original returns (one difference: an exception inside
scipy's ``milp`` reaches the caller instead of turning into ``None``).

Given multicast demands H (from the activated links of a mixing matrix),
choose for each flow h a directed Steiner tree in the overlay such that
the makespan under equal bandwidth sharing,

    τ(z) = max_{F ∈ 𝓕} (κ / C_F) · t_F(z),          (Lemma III.2, eq. 11)

is minimized, where t_F(z) counts activated unicast traversals of
category F's links. Two solvers:

  * ``route_milp``       — the paper's MILP (8) with category constraints
    (12), solved exactly by HiGHS (``scipy.optimize.milp``), including the
    Steiner-arborescence constraints (5d)-(5e).
  * ``route_congestion_aware`` — sequential cheapest-path Steiner insertion
    with exponential-potential re-routing; scales past MILP reach and is
    validated against the MILP on small instances. The default engine is
    vectorized: a precompiled ``CategoryIncidence`` (link×category CSR
    flat-entry arrays, the analogue of the simulator's
    ``BranchIncidence``) yields per-link costs in one ``bincount``, t_F
    loads and the completion time are maintained incrementally as numpy
    arrays on link add/remove, and each destination's cheapest path
    comes from a dense numpy Dijkstra whose relaxation is one vector op
    per settled node. The retained pure-Python original,
    ``_route_congestion_aware_reference``, is the ground truth the
    vectorized engine is property-tested against (identical trees on
    the same seed, hence τ_vec ≤ τ_ref).

``route`` picks MILP when the instance is small enough, else the
heuristic (the heuristic is skipped when the MILP proves optimality
within its budget), and always returns the better of
{solution, direct routing}; every candidate's completion time is kept in
``RoutingSolution.metadata["candidate_times"]``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Iterable, Mapping, MutableMapping, Sequence

import numpy as np

from repro_torch.net.categories import (
    Categories,
    CategoryIncidence,
    compile_category_incidence,
)
from repro_torch.net.demands import MulticastDemand


@dataclasses.dataclass(frozen=True)
class RoutingSolution:
    """Per-flow directed Steiner trees + derived quantities.

    ``trees[h]`` is the set of directed overlay links used by flow h
    (z^h_{ij} = 1), guaranteed to connect ``demands[h].source`` to every
    destination. ``metadata`` carries solver debugging detail (candidate
    completion times, MILP status) and never affects equality/hashing.
    """

    demands: tuple[MulticastDemand, ...]
    trees: tuple[frozenset, ...]
    completion_time: float
    method: str
    solve_seconds: float
    metadata: Mapping | None = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def link_uses(self) -> dict[tuple[int, int], int]:
        """Σ_h z^h_{ij} per directed overlay link (input to t_F)."""
        uses: dict[tuple[int, int], int] = {}
        for tree in self.trees:
            for l in tree:
                uses[l] = uses.get(l, 0) + 1
        return uses

    def flow_rate(self, categories: Categories) -> float:
        """Equal-share optimal per-flow rate d_h ≡ min_F C_F / t_F."""
        uses = self.link_uses()
        t = categories.load_vector(uses)
        return min(
            (categories.capacity[F] / t[F] for F in t if t[F] > 0),
            default=math.inf,
        )

    def unicast_branches(
        self, overlay
    ) -> tuple[tuple[int, tuple[int, int], tuple[tuple[int, int], ...]], ...]:
        """Expand every flow tree into activated unicast branches.

        Each directed overlay link (i, j) in flow h's tree is an activated
        unicast flow carrying h's content over the underlay path p_{i,j}
        (paper Lemma III.1's definition). Returns
        ``(flow, (i, j), underlay_edge_path)`` triples; the enumeration
        order is shared by every simulator engine so their event arithmetic
        is comparable term by term.
        """
        out = []
        for h, tree in enumerate(self.trees):
            for (i, j) in tree:
                out.append((h, (i, j), overlay.path_edges(i, j)))
        return tuple(out)


def _tree_connects(
    tree: frozenset, demand: MulticastDemand, num_agents: int
) -> bool:
    """Check s_h reaches every k ∈ T_h along directed tree edges."""
    adj: dict[int, list[int]] = {}
    for i, j in tree:
        adj.setdefault(i, []).append(j)
    seen = {demand.source}
    stack = [demand.source]
    while stack:
        u = stack.pop()
        for v in adj.get(u, ()):  # BFS/DFS over directed edges
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return demand.destinations <= seen


def validate_solution(sol: RoutingSolution, num_agents: int) -> None:
    for h, demand in enumerate(sol.demands):
        if not _tree_connects(sol.trees[h], demand, num_agents):
            raise ValueError(f"flow {h} tree does not span its destinations")


def completion_time(
    trees: Sequence[frozenset], categories: Categories, kappa: float
) -> float:
    uses: dict[tuple[int, int], int] = {}
    for tree in trees:
        for l in tree:
            uses[l] = uses.get(l, 0) + 1
    return categories.completion_time(uses, kappa)


# ---------------------------------------------------------------------------
# Direct (default-path) routing — the τ̄ upper bound of eq. (22)
# ---------------------------------------------------------------------------


def route_direct(
    demands: Sequence[MulticastDemand],
    categories: Categories,
    kappa: float,
) -> RoutingSolution:
    """Route each branch on its default overlay link (underlay default path)."""
    t0 = time.perf_counter()
    trees = tuple(
        frozenset((d.source, k) for k in d.destinations) for d in demands
    )
    return RoutingSolution(
        demands=tuple(demands),
        trees=trees,
        completion_time=completion_time(trees, categories, kappa),
        method="direct",
        solve_seconds=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Exact MILP (paper eq. (8) with category constraints (12))
# ---------------------------------------------------------------------------


def route_milp(
    demands: Sequence[MulticastDemand],
    categories: Categories,
    kappa: float,
    num_agents: int,
    time_limit: float = 120.0,
    sparsity_eps: float = 1e-6,
) -> RoutingSolution | None:
    """Solve the routing MILP exactly with HiGHS.

    Variables: τ; z^h_{ij} ∈ {0,1} per flow × directed link; r^{h,k}_{ij}
    ∈ {0,1} per flow × destination × directed link. Constraints (5d), (5e),
    (12). A tiny ε·Σz term breaks ties toward sparse trees (removes cycles
    that flow conservation alone permits). Returns None on failure.
    """
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp

    t0 = time.perf_counter()
    m = num_agents
    links = [(i, j) for i in range(m) for j in range(m) if i != j]
    L = len(links)
    link_idx = {l: a for a, l in enumerate(links)}
    H = len(demands)
    dests = [sorted(d.destinations) for d in demands]

    # Variable layout: [τ] ++ z (H×L) ++ r (Σ_h |T_h| × L)
    n_z = H * L
    r_offsets = []
    off = 1 + n_z
    for h in range(H):
        r_offsets.append(off)
        off += len(dests[h]) * L
    n_var = off

    def zvar(h: int, l: int) -> int:
        return 1 + h * L + l

    def rvar(h: int, ki: int, l: int) -> int:
        return r_offsets[h] + ki * L + l

    rows, cols, vals, lo, hi = [], [], [], [], []
    row = 0

    def add(entries, lb, ub):
        nonlocal row
        for c, v in entries:
            rows.append(row)
            cols.append(c)
            vals.append(v)
        lo.append(lb)
        hi.append(ub)
        row += 1

    # (5d) flow conservation per (h, k, node i).
    for h, d in enumerate(demands):
        for ki, k in enumerate(dests[h]):
            for i in range(m):
                b = 1.0 if i == d.source else (-1.0 if i == k else 0.0)
                entries = []
                for j in range(m):
                    if j == i:
                        continue
                    entries.append((rvar(h, ki, link_idx[(i, j)]), 1.0))
                    entries.append((rvar(h, ki, link_idx[(j, i)]), -1.0))
                add(entries, b, b)

    # (5e) r ≤ z.
    for h in range(H):
        for ki in range(len(dests[h])):
            for l in range(L):
                add([(rvar(h, ki, l), 1.0), (zvar(h, l), -1.0)], -np.inf, 0.0)

    # (12) τ ≥ (κ/C_F)·Σ_{(i,j)∈F} Σ_h z^h_{ij}.
    for F in categories.families:
        coef = kappa / categories.capacity[F]
        entries = [(0, 1.0)]
        for l_dir in F:
            if l_dir in link_idx:
                for h in range(H):
                    entries.append((zvar(h, link_idx[l_dir]), -coef))
        add(entries, 0.0, np.inf)

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(row, n_var))
    c = np.full(n_var, 0.0)
    c[0] = 1.0
    c[1 : 1 + n_z] = sparsity_eps  # tie-break toward sparse trees
    integrality = np.ones(n_var)
    integrality[0] = 0
    lb = np.zeros(n_var)
    ub = np.ones(n_var)
    ub[0] = np.inf

    # The reference returns None when ``milp`` raises; the port lets the
    # error through (it wraps no call in a ``try``), and returns None, as
    # the reference does, when the solver finds no solution.
    res = milp(
        c=c,
        constraints=LinearConstraint(A, lo, hi),
        integrality=integrality,
        bounds=Bounds(lb, ub),
        options={"time_limit": time_limit, "presolve": True},
    )
    if res.x is None:
        return None

    trees = []
    for h in range(H):
        z = res.x[1 + h * L : 1 + (h + 1) * L]
        tree = frozenset(links[a] for a in range(L) if z[a] > 0.5)
        trees.append(_prune_tree(tree, demands[h]))
    trees = tuple(trees)
    return RoutingSolution(
        demands=tuple(demands),
        trees=trees,
        completion_time=completion_time(trees, categories, kappa),
        method="milp",
        solve_seconds=time.perf_counter() - t0,
        metadata={"milp_status": int(res.status)},
    )


def _prune_tree(tree: frozenset, demand: MulticastDemand) -> frozenset:
    """Drop edges not on any source→destination directed path."""
    adj: dict[int, list[int]] = {}
    for i, j in tree:
        adj.setdefault(i, []).append(j)
    # Keep edges reachable from source AND from which a destination is
    # reachable. Compute reach-from-source and co-reach-to-dests.
    reach = {demand.source}
    stack = [demand.source]
    while stack:
        u = stack.pop()
        for v in adj.get(u, ()):
            if v not in reach:
                reach.add(v)
                stack.append(v)
    radj: dict[int, list[int]] = {}
    for i, j in tree:
        radj.setdefault(j, []).append(i)
    coreach = set(demand.destinations)
    stack = list(demand.destinations)
    while stack:
        u = stack.pop()
        for v in radj.get(u, ()):
            if v not in coreach:
                coreach.add(v)
                stack.append(v)
    return frozenset(
        (i, j) for (i, j) in tree if i in reach and j in coreach
    )


# ---------------------------------------------------------------------------
# Congestion-aware heuristic (exponential potential, cheapest-path Steiner)
# ---------------------------------------------------------------------------


def _link_category_costs(
    categories: Categories, num_agents: int, kappa: float
) -> dict[tuple[int, int], list[tuple[int, float]]]:
    """Per directed overlay link: [(category index, κ/C_F), ...]."""
    fams = categories.families
    out: dict[tuple[int, int], list[tuple[int, float]]] = {}
    for fi, F in enumerate(fams):
        coef = kappa / categories.capacity[F]
        for l in F:
            out.setdefault(l, []).append((fi, coef))
    return out


def _route_congestion_aware_reference(
    demands: Sequence[MulticastDemand],
    categories: Categories,
    kappa: float,
    num_agents: int,
    rounds: int = 8,
    seed: int = 0,
) -> RoutingSolution:
    """Pure-Python congestion-aware routing (retained ground truth).

    The original O(m²)-per-destination dict-loop implementation. Kept —
    like the simulator's reference engine — as the oracle the vectorized
    ``route_congestion_aware`` is property-tested against: on the same
    seed both engines must produce identical trees.
    """
    t0 = time.perf_counter()
    m = num_agents
    rng = np.random.default_rng(seed)
    fams = categories.families
    nF = len(fams)
    cat_cost = _link_category_costs(categories, m, kappa)
    cap = np.array(
        [categories.capacity[F] for F in fams], dtype=np.float64
    )

    # t_F loads, maintained incrementally.
    loads = np.zeros(nF)
    trees: list[set] = [set() for _ in demands]
    # link -> category indices + coefs as arrays for speed
    link_cats = {
        l: (np.array([fi for fi, _ in cc], dtype=np.int64),)
        for l, cc in cat_cost.items()
    }

    def add_link(h: int, l: tuple[int, int]) -> None:
        if l not in trees[h]:
            trees[h].add(l)
            idx = link_cats.get(l)
            if idx is not None:
                loads[idx[0]] += 1

    def remove_flow(h: int) -> None:
        for l in trees[h]:
            idx = link_cats.get(l)
            if idx is not None:
                loads[idx[0]] -= 1
        trees[h].clear()

    def route_flow(h: int, theta: float) -> None:
        d = demands[h]
        # Utilization per category (seconds) under current loads.
        util = kappa * loads / cap
        peak = max(util.max(), 1e-12)
        w = np.exp(theta * (util / peak))  # bounded exponent
        for k in sorted(d.destinations, key=lambda _: rng.random()):
            # Dijkstra from source over directed links; links already in
            # tree are free (shared multicast traffic).
            dist = np.full(m, np.inf)
            prev = np.full(m, -1, dtype=np.int64)
            dist[d.source] = 0.0
            done = np.zeros(m, dtype=bool)
            for _ in range(m):
                u = int(np.argmin(np.where(done, np.inf, dist)))
                if done[u] or not np.isfinite(dist[u]):
                    break
                done[u] = True
                for v in range(m):
                    if v == u:
                        continue
                    l = (u, v)
                    if l in trees[h]:
                        c = 0.0
                    else:
                        cc = cat_cost.get(l, ())
                        c = sum(
                            coef * w[fi] for fi, coef in cc
                        ) + 1e-12  # strictly positive off-tree
                    if dist[u] + c < dist[v]:
                        dist[v] = dist[u] + c
                        prev[v] = u
            # Walk back from k, adding links.
            node = k
            chain = []
            while node != d.source and prev[node] >= 0:
                chain.append((int(prev[node]), int(node)))
                node = int(prev[node])
            if node != d.source:
                # Unreachable (should not happen on a full overlay): direct.
                chain = [(d.source, k)]
            for l in chain:
                add_link(h, l)

    best_trees: tuple[frozenset, ...] | None = None
    best_tau = math.inf

    # Initial: direct routing.
    for h, d in enumerate(demands):
        for k in d.destinations:
            add_link(h, (d.source, k))

    order = list(range(len(demands)))
    for rnd in range(rounds):
        theta = 2.0 + 3.0 * rnd  # anneal toward harder bottleneck avoidance
        rng.shuffle(order)
        for h in order:
            remove_flow(h)
            route_flow(h, theta)
        tau = completion_time([frozenset(t) for t in trees], categories, kappa)
        if tau < best_tau - 1e-15:
            best_tau = tau
            best_trees = tuple(frozenset(t) for t in trees)

    assert best_trees is not None
    return RoutingSolution(
        demands=tuple(demands),
        trees=best_trees,
        completion_time=best_tau,
        method="congestion_aware_reference",
        solve_seconds=time.perf_counter() - t0,
    )


def route_congestion_aware(
    demands: Sequence[MulticastDemand],
    categories: Categories,
    kappa: float,
    num_agents: int,
    rounds: int = 8,
    seed: int = 0,
    incidence: CategoryIncidence | None = None,
) -> RoutingSolution:
    """Potential-based multicast routing (scales beyond the MILP).

    Each flow's tree is built by *cheapest-path Steiner insertion*: route
    to destinations one at a time over link costs that (a) are zero for
    links already in the flow's tree (multicast branches share traffic)
    and (b) grow exponentially with category utilization, so bottleneck
    categories repel new flows. Several re-routing rounds with annealed
    temperature; the best τ seen wins.

    Vectorized engine: per-link costs come from one ``bincount`` over the
    precompiled ``CategoryIncidence`` flat entries (pass ``incidence`` to
    amortize compilation across calls, e.g. over a design-sweep grid),
    t_F loads update incrementally on link add/remove, the per-round τ is
    read straight off the load vector, and each destination's cheapest
    path is a dense numpy Dijkstra (one vectorized relaxation per settled
    node, early exit at the destination). Produces trees identical to
    ``_route_congestion_aware_reference`` on the same seed: the RNG draw
    sequence, cost arithmetic (same per-link summation order), argmin
    tie-breaks, and annealing schedule are replicated exactly.
    """
    t0 = time.perf_counter()
    m = num_agents
    rng = np.random.default_rng(seed)
    inc = (
        incidence
        if incidence is not None
        else compile_category_incidence(categories, m, kappa)
    )
    if inc.num_agents != m or inc.kappa != kappa:
        raise ValueError(
            f"incidence compiled for (m={inc.num_agents}, κ={inc.kappa}), "
            f"got (m={m}, κ={kappa})"
        )
    if not inc.matches(categories):
        raise ValueError(
            "incidence was compiled from different categories; recompile "
            "with compile_category_incidence(categories, m, kappa)"
        )
    cap = inc.capacity
    ecat, eptr = inc.entry_cat, inc.link_ptr

    # t_F loads, maintained incrementally (integer-valued float64).
    loads = np.zeros(inc.num_categories)
    trees: list[set] = [set() for _ in demands]

    def add_link(h: int, l: tuple[int, int]) -> None:
        if l not in trees[h]:
            trees[h].add(l)
            a = l[0] * m + l[1]
            loads[ecat[eptr[a]:eptr[a + 1]]] += 1.0

    def remove_flow(h: int) -> None:
        for (i, j) in trees[h]:
            a = i * m + j
            loads[ecat[eptr[a]:eptr[a + 1]]] -= 1.0
        trees[h].clear()

    def route_flow(h: int, theta: float) -> None:
        d = demands[h]
        # Utilization per category (seconds) under current loads.
        util = kappa * loads / cap
        peak = max(util.max(), 1e-12) if util.size else 1e-12
        w = np.exp(theta * (util / peak))  # bounded exponent
        # Off-tree link costs: one bincount over the flat entries, plus
        # the reference's strictly-positive 1e-12 floor.
        cost = (inc.link_costs(w) + 1e-12).reshape(m, m)
        np.fill_diagonal(cost, np.inf)
        # trees[h] is empty here (route_flow always follows remove_flow);
        # in-tree links become free via the chain zeroing below.
        for k in sorted(d.destinations, key=lambda _: rng.random()):
            # Dense Dijkstra from the source: one vectorized relaxation
            # per settled node. ``work`` is dist with settled nodes
            # masked to inf, so argmin doubles as the frontier pop.
            dist = np.full(m, np.inf)
            dist[d.source] = 0.0
            work = dist.copy()
            prev = np.full(m, -1, dtype=np.int64)
            for _ in range(m):
                u = int(np.argmin(work))
                if not np.isfinite(work[u]):
                    break
                work[u] = np.inf
                if u == k:
                    break  # dist/prev along k's chain are already final
                cand = dist[u] + cost[u]
                upd = cand < dist  # settled nodes can never improve
                if upd.any():
                    dist[upd] = cand[upd]
                    work[upd] = cand[upd]
                    prev[upd] = u
            # Walk back from k, adding links (free for later siblings).
            node = k
            chain = []
            while node != d.source and prev[node] >= 0:
                chain.append((int(prev[node]), int(node)))
                node = int(prev[node])
            if node != d.source:
                # Unreachable (should not happen on a full overlay): direct.
                chain = [(d.source, k)]
            for l in chain:
                add_link(h, l)
                cost[l] = 0.0

    best_trees: tuple[frozenset, ...] | None = None
    best_tau = math.inf

    # Initial: direct routing.
    for h, d in enumerate(demands):
        for k in d.destinations:
            add_link(h, (d.source, k))

    order = list(range(len(demands)))
    for rnd in range(rounds):
        theta = 2.0 + 3.0 * rnd  # anneal toward harder bottleneck avoidance
        rng.shuffle(order)
        for h in order:
            remove_flow(h)
            route_flow(h, theta)
        # Incremental completion time: read τ off the maintained loads
        # instead of rebuilding the link-uses dict from every tree.
        tau = inc.completion_time(loads)
        if tau < best_tau - 1e-15:
            best_tau = tau
            best_trees = tuple(frozenset(t) for t in trees)

    assert best_trees is not None
    return RoutingSolution(
        demands=tuple(demands),
        trees=best_trees,
        completion_time=best_tau,
        method="congestion_aware",
        solve_seconds=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------


def route(
    demands: Sequence[MulticastDemand],
    categories: Categories,
    kappa: float,
    num_agents: int,
    milp_var_budget: int = 40_000,
    time_limit: float = 60.0,
    seed: int = 0,
    incidence: CategoryIncidence | None = None,
    heuristic_rounds: int = 8,
) -> RoutingSolution:
    """Best-effort optimal routing.

    Uses the exact MILP when the variable count is within budget, else the
    congestion-aware heuristic; always returns the best of the candidate
    solutions (never worse than direct routing — paper footnote 6). When
    the MILP covers the instance and proves optimality within its time
    limit, the (then redundant) heuristic is skipped entirely. Every
    candidate's completion time lands in
    ``metadata["candidate_times"]`` for debugging; ``incidence`` (a
    precompiled ``CategoryIncidence``) and ``heuristic_rounds`` tune the
    heuristic for repeated calls, e.g. across a design-sweep grid.
    """
    if not demands:
        return RoutingSolution(
            demands=(), trees=(), completion_time=0.0, method="empty",
            solve_seconds=0.0, metadata={"candidate_times": {}},
        )
    m = num_agents
    L = m * (m - 1)
    n_r = sum(len(d.destinations) for d in demands) * L
    n_var = 1 + len(demands) * L + n_r

    candidates = [route_direct(demands, categories, kappa)]
    milp_sol = None
    if n_var <= milp_var_budget:
        milp_sol = route_milp(
            demands, categories, kappa, m, time_limit=time_limit
        )
        if milp_sol is not None:
            candidates.append(milp_sol)
    milp_optimal = (
        milp_sol is not None
        and milp_sol.metadata is not None
        and milp_sol.metadata.get("milp_status") == 0  # HiGHS: proven opt
    )
    if not milp_optimal:
        candidates.append(
            route_congestion_aware(
                demands, categories, kappa, m, rounds=heuristic_rounds,
                seed=seed, incidence=incidence,
            )
        )
    best = min(candidates, key=lambda s: s.completion_time)
    validate_solution(best, m)
    meta = dict(best.metadata or {})
    meta["candidate_times"] = {
        s.method: s.completion_time for s in candidates
    }
    return dataclasses.replace(best, metadata=meta)


# ---------------------------------------------------------------------------
# Phase-adaptive (time-expanded) routing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhasedRoutingSolution:
    """One routing per capacity phase plus the breakpoint schedule.

    ``solutions[k]`` is the routing used on ``[boundaries[k],
    boundaries[k+1])`` (the last segment runs to ∞); ``boundaries[0]``
    is always 0.0. Segment 0 routes against the base categories, so on
    a trivial scenario the whole object degenerates to the static
    ``route()`` answer (bitwise — property-tested).
    ``completion_time`` is segment 0's closed-form τ (the static value
    if phase 0 capacities held forever); the exact phased makespan
    comes from ``repro_torch.net.simulate_phased``.
    """

    demands: tuple[MulticastDemand, ...]
    boundaries: tuple[float, ...]
    solutions: tuple["RoutingSolution", ...]
    completion_time: float
    method: str
    solve_seconds: float
    metadata: Mapping | None = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def __post_init__(self):
        if len(self.boundaries) != len(self.solutions):
            raise ValueError("one routing solution per boundary required")
        if not self.boundaries or self.boundaries[0] != 0.0:
            raise ValueError("first segment must start at t=0")
        if any(
            b <= a for a, b in zip(self.boundaries, self.boundaries[1:])
        ):
            raise ValueError("boundaries must be strictly increasing")

    @property
    def num_segments(self) -> int:
        return len(self.solutions)

    @property
    def is_static(self) -> bool:
        """True when every segment reuses segment 0's trees."""
        return all(s.trees == self.solutions[0].trees for s in self.solutions)

    def active_solution(self, t: float) -> "RoutingSolution":
        """The routing in force at time ``t`` (piecewise-constant)."""
        k = 0
        for seg, start in enumerate(self.boundaries):
            if start <= t:
                k = seg
        return self.solutions[k]


def _phase_segments(scenario) -> list[tuple[float, object]]:
    """(start, scale) per routing segment from a scenario's capacity
    phases: segment 0 covers t=0 under the latest phase with start ≤ 0
    (base scale 1.0 if none); every later phase start opens a segment.
    Consecutive segments with identical scales are merged."""
    by_start: dict[float, object] = {0.0: 1.0}
    for ph in sorted(scenario.capacity_phases, key=lambda p: p.start):
        # Duplicate starts: the last phase in sorted order wins, matching
        # the simulator's event loop (it applies every phase with
        # start <= t in order, so the final one sticks).
        by_start[max(float(ph.start), 0.0)] = ph.scale
    segs = sorted(by_start.items())
    merged = [segs[0]]
    for start, scale in segs[1:]:
        if _scale_key(scale) != _scale_key(merged[-1][1]):
            merged.append((start, scale))
    return merged


def _scale_key(scale) -> object:
    """Hashable fingerprint of a CapacityPhase scale (for caching)."""
    if isinstance(scale, Mapping):
        return tuple(
            sorted((tuple(e), float(f)) for e, f in scale.items())
        )
    return float(scale)


def _carryover_completion_time(
    trees: Sequence[frozenset],
    demands: Sequence[MulticastDemand],
    categories: Categories,
    state,
) -> float:
    """Remaining completion time of ``trees`` given realized per-branch
    state — the carryover-aware segment objective of online re-routing.

    Generalizes Lemma III.2's τ to heterogeneous residual volumes: per
    category F the bottleneck must still carry
    Σ_{(i,j)∈F} Σ_h v_{h,(i,j)} bytes, where a branch's volume v is the
    flow's full size for a *fresh* overlay link (the restart cost a
    swap incurs — mid-flight data on abandoned links is lost), the
    carried remainder for a surviving in-flight link, and 0 for a
    branch that already finished. Branches of delivered flows,
    cancelled branches, and branches touching departed agents carry
    nothing. ``state`` is a ``repro_torch.net.simulator.CarryoverState``.
    """
    departed = set(state.departed)
    vol: dict[tuple[int, int], float] = {}
    for h, tree in enumerate(trees):
        if not math.isnan(state.flow_done[h]):
            continue  # flow already delivered everywhere it could
        if demands[h].source in departed:
            continue  # nothing left to send; churn cancelled the flow
        for (i, j) in tree:
            key = (h, i, j)
            if key in state.cancelled or i in departed or j in departed:
                continue
            v = state.remaining.get(key)
            if v is None:
                v = 0.0 if key in state.done else float(demands[h].size)
            if v > 0.0:
                vol[(i, j)] = vol.get((i, j), 0.0) + v
    if not vol:
        return 0.0
    return max(
        (
            sum(vol.get(l, 0.0) for l in F) / categories.capacity[F]
            for F in categories.families
        ),
        default=0.0,
    )


def route_time_expanded(
    demands: Sequence[MulticastDemand],
    categories: Categories,
    scenario,
    kappa: float,
    num_agents: int,
    milp_var_budget: int = 40_000,
    time_limit: float = 60.0,
    seed: int = 0,
    incidence: CategoryIncidence | None = None,
    heuristic_rounds: int = 8,
    routing_cache: "MutableMapping | None" = None,
    cache_key=None,
    base_solution: "RoutingSolution | None" = None,
    online: bool = False,
    overlay=None,
) -> PhasedRoutingSolution:
    """Time-expanded routing: one ``route()`` per capacity phase.

    The scenario's piecewise-constant ``capacity_phases`` partition time
    into segments; each segment is routed against the phase-scaled
    categories (``Categories.scaled``), so the schedule tracks where the
    bottlenecks actually are in each phase instead of optimizing once
    for capacities that stop being true at the first boundary. Segments
    with equal scales share one solution, and ``routing_cache`` (with a
    ``cache_key`` identifying the demand set, e.g. the activated-link
    frozenset) memoizes per-(demands, scale) across calls — a design
    sweep rarely re-routes. ``incidence`` is rescaled per phase
    (``CategoryIncidence.rescaled``) rather than recompiled, and
    ``base_solution`` (a static ``route()`` result the caller already
    holds) is reused for unscaled segments instead of being re-solved.

    Re-routing is guarded against pointless swaps: a segment only
    abandons the previous segment's trees when the re-route is
    *strictly* better in closed form under the new phase's categories.
    Swapping restarts the branches on fresh overlay links from zero
    (mid-flight data on abandoned links is lost), so a zero-predicted-
    gain swap can only cost time.

    On a trivial scenario (no capacity phases) this returns a single
    segment that is bitwise-identical to static ``route()`` with the
    same arguments. ``metadata['routed_segments']`` counts the segments
    actually solved this call (vs. served from the cache).

    ``online=True`` switches to *observed-state* re-routing (requires
    ``overlay``): the scenario is a realized sample (e.g. from
    ``StochasticScenario.sample``) that the router pretends to discover
    phase by phase — at each boundary it sees only the capacities
    realized so far (``carryover_state`` simulates the committed prefix,
    which applies no condition beyond the boundary, so there is no
    lookahead), and the keep-vs-switch decision uses the
    *carryover-aware* objective ``_carryover_completion_time``: the
    restart cost of abandoning in-flight links (their volume restarts
    from full κ) is charged explicitly instead of the offline swap
    guard's full-volume closed form. A switch happens only when it is
    strictly better under that objective; ``metadata['reroutes']``
    counts the boundaries that actually switched trees. Each decision
    re-simulates the committed prefix from t=0 (O(boundaries²) segment
    events per realization — fine for the diurnal-scale scenarios the
    benchmarks use; an incremental-resume snapshot is the known
    optimization if realizations ever have hundreds of distinct-tree
    boundaries).
    """
    t0 = time.perf_counter()
    if online and overlay is None:
        raise ValueError(
            "online re-routing needs the overlay to snapshot realized "
            "state (carryover_state)"
        )
    segs = _phase_segments(scenario)
    boundaries = tuple(start for start, _ in segs)
    solutions: list[RoutingSolution] = []
    by_scale: dict = {}
    routed = 0
    reroutes = 0
    for si, (start, scale) in enumerate(segs):
        key = _scale_key(scale)
        seg_cats = categories.scaled(scale)
        # The raw per-scale solution is what gets cached; the swap guard
        # below is applied per call (its outcome depends on the previous
        # segment, which differs between phase sequences).
        sol = by_scale.get(key)
        if sol is None and routing_cache is not None and cache_key is not None:
            sol = routing_cache.get((cache_key, key))
        if sol is None and base_solution is not None and seg_cats is categories:
            # A caller that already solved the static routing (the base,
            # unscaled categories) supplies it — segment 0 of a no-
            # phase-at-t≤0 schedule would otherwise re-solve it bitwise.
            sol = base_solution
        if sol is None:
            seg_inc = None
            if incidence is not None:
                seg_inc = (
                    incidence if seg_cats is categories
                    else incidence.rescaled(seg_cats)
                )
            sol = route(
                demands, seg_cats, kappa, num_agents,
                milp_var_budget=milp_var_budget, time_limit=time_limit,
                seed=seed, incidence=seg_inc,
                heuristic_rounds=heuristic_rounds,
            )
            routed += 1
        by_scale[key] = sol
        if routing_cache is not None and cache_key is not None:
            routing_cache[(cache_key, key)] = sol
        if solutions:
            prev = solutions[-1]
            if sol is prev or sol.trees == prev.trees:
                sol = prev  # same trees: never a swap, share the object
            elif online:
                # Observed-state decision: simulate the committed
                # schedule up to this boundary (no condition beyond it
                # is applied — no lookahead) and compare the carryover-
                # aware remaining times. Switching charges the restart
                # of every in-flight branch whose link the new trees
                # abandon; keeping charges only the carried remainders.
                from repro_torch.net.simulator import carryover_state

                prefix = PhasedRoutingSolution(
                    demands=tuple(demands),
                    boundaries=boundaries[:si],
                    solutions=tuple(solutions),
                    completion_time=solutions[0].completion_time,
                    method="online_prefix",
                    solve_seconds=0.0,
                )
                state = carryover_state(
                    prefix, overlay, start, scenario=scenario
                )
                t_keep = _carryover_completion_time(
                    prev.trees, demands, seg_cats, state
                )
                t_switch = _carryover_completion_time(
                    sol.trees, demands, seg_cats, state
                )
                if t_switch < t_keep:
                    reroutes += 1
                else:
                    sol = prev
            else:
                # Offline swap guard: keep the in-flight trees unless
                # the re-route strictly improves the closed-form τ
                # under this phase's capacities.
                if (
                    completion_time(prev.trees, seg_cats, kappa)
                    <= sol.completion_time
                ):
                    sol = prev
                else:
                    reroutes += 1
        solutions.append(sol)
    return PhasedRoutingSolution(
        demands=tuple(demands),
        boundaries=boundaries,
        solutions=tuple(solutions),
        completion_time=solutions[0].completion_time,
        method="time_expanded_online" if online else "time_expanded",
        solve_seconds=time.perf_counter() - t0,
        metadata={
            "segment_times": tuple(s.completion_time for s in solutions),
            "segment_methods": tuple(s.method for s in solutions),
            "routed_segments": routed,
            "reroutes": reroutes,
        },
    )
