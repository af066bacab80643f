"""Stochastic scenario layer — Markov-modulated links, correlated
outages, random churn (ROADMAP "stochastic capacity processes").

The port's own copy of the JAX package's ``net/stochastic.py``: the same
seeded draws, bitwise.

The deterministic ``Scenario`` prices a design against ONE realization
of the network's future. Real edge links fluctuate stochastically, so
this module describes *distributions* over scenarios and draws seeded
realizations from them:

  * ``MarkovLinkModel``    — a discrete-time Markov chain modulating the
    capacity of a group of underlay edges (states = capacity scales,
    e.g. good/degraded/outage), stepped at fixed boundary spacing.
  * ``CorrelatedOutages``  — a shared-shock process: one global shock
    (weather, backhaul flap, interference burst) hits several edge
    groups at once, so outages are *correlated* across links instead of
    independent — the regime that actually breaks single-path designs.
  * ``StochasticScenario`` — composes the above (plus optional random
    agent churn and a deterministic ``base`` scenario) on a fixed
    horizon. ``sample(key)`` draws one concrete piecewise-constant
    realization as an ordinary ``Scenario`` reusing ``CapacityPhase`` /
    ``ChurnEvent`` — so every existing consumer (``simulate``,
    ``simulate_phased``, ``evaluate_design``,
    ``FaultToleranceController``) prices realizations unchanged.

Sampling is deterministic in the key: the same key yields a bitwise-
identical realization (property-tested), which makes stochastic pricing
(`evaluate_design(stochastic_rollouts=N)`) a *seeded expectation* — a
reproducible number, not a flaky one. The per-step draw order is fixed
(Markov models in declaration order, then the outage shock, then churn
hazards), so adding draws at the end of a step never perturbs earlier
ones within the same release.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.net.simulator import (
    CapacityPhase,
    ChurnEvent,
    Scenario,
    _phase_capacity_array,
)


@dataclasses.dataclass(frozen=True)
class MarkovLinkModel:
    """Discrete-time Markov-modulated capacity process on a group of
    underlay edges.

    All edges in ``edges`` share one chain (they degrade together — a
    congested backhaul region, a shared radio channel). ``scales[s]`` is
    the capacity multiplier in state ``s``; ``transition[s]`` is the
    row-stochastic distribution of the next state, applied at every
    boundary of the enclosing ``StochasticScenario``. A one-state model
    with ``scales == (1.0,)`` is the degenerate deterministic link —
    its realizations are trivially static (property-tested).
    """

    edges: tuple[tuple[int, int], ...]
    scales: tuple[float, ...]
    transition: tuple[tuple[float, ...], ...]
    initial: int = 0

    def validate(self) -> None:
        n = len(self.scales)
        if n == 0:
            raise ValueError("MarkovLinkModel needs at least one state")
        if not self.edges:
            raise ValueError("MarkovLinkModel needs at least one edge")
        if any(s <= 0 for s in self.scales):
            raise ValueError("capacity scales must be positive")
        if not 0 <= self.initial < n:
            raise ValueError(
                f"initial state {self.initial} out of range for {n} states"
            )
        if len(self.transition) != n:
            raise ValueError("transition matrix must be square in #states")
        for row in self.transition:
            if len(row) != n:
                raise ValueError(
                    "transition matrix must be square in #states"
                )
            if any(p < 0 for p in row):
                raise ValueError("transition probabilities must be >= 0")
            if not math.isclose(sum(row), 1.0, rel_tol=0, abs_tol=1e-9):
                raise ValueError(
                    f"transition rows must sum to 1 (got {sum(row)!r})"
                )

    @property
    def is_degenerate(self) -> bool:
        """True when the chain can never leave a scale-1.0 state set
        reachable from ``initial`` — i.e. one state at base capacity."""
        return len(self.scales) == 1 and float(self.scales[0]) == 1.0


@dataclasses.dataclass(frozen=True)
class CorrelatedOutages:
    """Shared-shock outage process over several edge groups.

    At every boundary a global shock fires with probability
    ``shock_prob``; conditional on the shock, each group independently
    joins the outage with probability ``group_prob`` and drops to
    ``scale`` × base capacity for ``duration_steps`` boundaries. Because
    the groups share the shock draw, outages are correlated — several
    regions of the underlay sag *simultaneously*, which is the case a
    per-link-independent model understates.
    """

    groups: tuple[tuple[tuple[int, int], ...], ...]
    shock_prob: float
    group_prob: float = 1.0
    duration_steps: int = 1
    scale: float = 0.05

    def validate(self) -> None:
        if not self.groups or any(not g for g in self.groups):
            raise ValueError("outage groups must be nonempty")
        for p, name in (
            (self.shock_prob, "shock_prob"),
            (self.group_prob, "group_prob"),
        ):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.duration_steps < 1:
            raise ValueError("duration_steps must be >= 1")
        if self.scale <= 0:
            raise ValueError("outage scale must be positive")


@dataclasses.dataclass(frozen=True)
class StochasticScenario:
    """Distribution over ``Scenario`` realizations on a fixed horizon.

    ``step`` is the boundary spacing in seconds: all stochastic
    processes evolve at t = 0, step, 2·step, … < ``horizon`` (the last
    sampled state persists beyond the horizon — capacity phases are
    piecewise-constant to ∞). ``base`` carries deterministic events
    (cross-traffic, stragglers, scheduled churn) folded into every
    realization; it must not carry capacity phases of its own — the
    sampled per-edge scales would not compose with them (the simulator
    applies the *latest* phase, it does not multiply overlapping ones).

    ``churn_hazard`` gives each agent in ``churn_agents`` an independent
    per-boundary departure probability (departure is absorbing; the
    resulting ``ChurnEvent``s reuse the deterministic machinery).

    ``sample(key)`` accepts anything ``np.random.default_rng`` accepts
    (an int, a tuple of ints, a ``SeedSequence``) and is bitwise-
    deterministic in it.
    """

    links: tuple[MarkovLinkModel, ...] = ()
    outages: CorrelatedOutages | None = None
    step: float = 60.0
    horizon: float = 600.0
    base: Scenario = Scenario()
    churn_agents: tuple[int, ...] = ()
    churn_hazard: float = 0.0

    def validate(self) -> None:
        if self.step <= 0:
            raise ValueError("step must be positive")
        if self.horizon < self.step:
            raise ValueError("horizon must cover at least one step")
        for model in self.links:
            model.validate()
        if self.outages is not None:
            self.outages.validate()
        if self.base.capacity_phases:
            raise ValueError(
                "base scenario must not carry capacity phases: sampled "
                "per-edge scales do not compose with deterministic "
                "phases (the simulator applies the latest phase, it "
                "does not multiply overlapping ones)"
            )
        if not 0.0 <= self.churn_hazard <= 1.0:
            raise ValueError("churn_hazard must be in [0, 1]")
        if self.churn_hazard > 0 and not self.churn_agents:
            raise ValueError("churn_hazard needs churn_agents")
        self.base.validate()

    @property
    def num_steps(self) -> int:
        return int(math.ceil(self.horizon / self.step))

    @property
    def is_trivial(self) -> bool:
        """True when every realization is the (static) base scenario."""
        return (
            all(m.is_degenerate for m in self.links)
            and self.outages is None
            and self.churn_hazard == 0.0
        )

    def sample(self, key) -> Scenario:
        """Draw one piecewise-constant realization as a ``Scenario``.

        Bitwise-deterministic in ``key``. Consecutive boundaries with an
        unchanged effective scale map emit no phase (realizations are
        minimal), and a map that returns to all-ones emits a scalar
        ``scale=1.0`` recovery phase.
        """
        self.validate()
        rng = np.random.default_rng(key)
        states = [m.initial for m in self.links]
        outage_left = (
            [0] * len(self.outages.groups) if self.outages is not None
            else []
        )
        phases: list[CapacityPhase] = []
        churn: list[ChurnEvent] = []
        alive = list(self.churn_agents)
        prev_map: dict[tuple[int, int], float] = {}
        for k in range(self.num_steps):
            t = k * self.step
            # 1. Markov transitions (models in declaration order; the
            # initial states apply at t=0, transitions from the first
            # boundary on).
            if k > 0:
                for mi, model in enumerate(self.links):
                    row = model.transition[states[mi]]
                    states[mi] = int(rng.choice(len(row), p=row))
            # 2. Correlated outage shock (one draw gates every group).
            if self.outages is not None:
                outage_left = [max(0, d - 1) for d in outage_left]
                if rng.random() < self.outages.shock_prob:
                    for gi in range(len(self.outages.groups)):
                        if rng.random() < self.outages.group_prob:
                            outage_left[gi] = self.outages.duration_steps
            # 3. Churn hazards (absorbing; agents in declaration order).
            if self.churn_hazard > 0:
                still = []
                for agent in alive:
                    if rng.random() < self.churn_hazard:
                        churn.append(ChurnEvent(agent=agent, time=t))
                    else:
                        still.append(agent)
                alive = still
            # Effective scale per edge: product over Markov models and
            # active outage groups touching it (multiplicative — a
            # degraded link inside an outage region sags twice).
            scale_map: dict[tuple[int, int], float] = {}
            for mi, model in enumerate(self.links):
                f = float(model.scales[states[mi]])
                if f != 1.0:
                    for e in model.edges:
                        scale_map[e] = scale_map.get(e, 1.0) * f
            if self.outages is not None:
                for gi, left in enumerate(outage_left):
                    if left > 0:
                        for e in self.outages.groups[gi]:
                            scale_map[e] = (
                                scale_map.get(e, 1.0) * self.outages.scale
                            )
            if scale_map != prev_map and not (k == 0 and not scale_map):
                phases.append(
                    CapacityPhase(
                        start=t,
                        scale=dict(scale_map) if scale_map else 1.0,
                    )
                )
            prev_map = scale_map
        churn.extend(self.base.churn)
        return Scenario(
            capacity_phases=tuple(phases),
            cross_traffic=self.base.cross_traffic,
            stragglers=self.base.stragglers,
            churn=tuple(
                sorted(churn, key=lambda c: (c.time, c.agent))
            ),
            floor_frac=self.base.floor_frac,
        )

    def sample_many(self, seed, n: int) -> tuple[Scenario, ...]:
        """N independent realizations, seeded as (seed, rollout-index) —
        the contract ``evaluate_design(stochastic_rollouts=N)`` uses, so
        rollout r of a sweep is reproducible in isolation."""
        return tuple(self.sample((seed, r)) for r in range(n))

    def realization_batch(
        self, seed, n: int, incidence, extra_boundaries=()
    ) -> "RealizationBatch":
        """N realizations densified for the device engine: the same
        seeded draws as ``sample_many(seed, n)`` (bitwise — the batch
        wraps those very ``Scenario`` objects), lowered onto a shared
        boundary grid as one ``[rollouts, phases, edges]`` capacity
        tensor over ``incidence``'s indexed edges, so
        ``torch_engine.simulate_rollout_batch`` can price the whole
        Monte-Carlo batch in one device pass."""
        return densify_realizations(
            self.sample_many(seed, n), incidence,
            extra_boundaries=extra_boundaries,
        )


def realization_deltas(
    scenario: Scenario,
) -> tuple[tuple[float, dict[tuple[int, int], float]], ...]:
    """Event-source a sampled realization: per capacity phase, the edges
    whose effective scale *changed* at that boundary.

    ``StochasticScenario.sample`` emits minimal piecewise-constant
    phases, but each phase carries the full *absolute* scale map. The
    design service wants deltas — only the links that actually moved —
    so it can absorb or patch per touched edge instead of re-scanning
    the whole map. Each returned entry is ``(time, {edge: new_scale})``
    where ``new_scale`` is the absolute multiplier vs base capacity
    (1.0 means the edge recovered). Edges inside each delta are emitted
    in sorted order so downstream iteration is deterministic.

    Only scalar-1.0 phases (all-clear recovery, the only scalar form
    ``sample`` emits) and per-edge maps are accepted; a scalar phase
    with scale != 1.0 would need the underlay edge set to expand and is
    rejected.
    """
    deltas: list[tuple[float, dict[tuple[int, int], float]]] = []
    prev: dict[tuple[int, int], float] = {}
    for phase in scenario.capacity_phases:
        if isinstance(phase.scale, (int, float)):
            if float(phase.scale) != 1.0:
                raise ValueError(
                    "realization_deltas needs per-edge scale maps; got a "
                    f"scalar phase with scale={phase.scale!r}"
                )
            cur: dict[tuple[int, int], float] = {}
        else:
            cur = {e: float(s) for e, s in phase.scale.items()}
        changed = {
            e: cur.get(e, 1.0)
            for e in sorted({*prev, *cur})
            if cur.get(e, 1.0) != prev.get(e, 1.0)
        }
        if changed:
            deltas.append((float(phase.start), changed))
        prev = cur
    return tuple(deltas)


@dataclasses.dataclass(frozen=True)
class RealizationBatch:
    """Dense device-ready view of N sampled realizations.

    ``starts`` ([P] float64, first entry 0.0) is the shared boundary
    grid — the union of every realization's phase starts and churn
    times (plus any caller-supplied extra boundaries). Stochastic
    processes evolve on the fixed t = k·step grid, so realizations
    share their boundaries and the union stays O(num_steps), which is
    what lets ``vmap`` batch rollouts under one static shape.

    ``capacity[r, p]`` is realization r's effective capacity vector on
    the grid interval starting at ``starts[p]``, indexed on the
    compiling ``BranchIncidence``'s edges. Each row is produced by the
    same ``_phase_capacity_array`` the numpy event loop evaluates, so
    the per-realization capacities are bitwise-equal to what
    ``simulate(scenario=sample(key))`` would see — the engines diverge
    only in fp drain grouping, never in inputs.

    ``churn[r]`` carries realization r's churn events (the one
    per-rollout quantity besides capacities), and ``realizations``
    keeps the underlying ``Scenario`` objects for the numpy parity
    oracle.
    """

    starts: np.ndarray  # [P] float64 boundary grid, starts at 0.0
    capacity: np.ndarray  # [R, P, E] float64 effective capacities
    churn: tuple[tuple[ChurnEvent, ...], ...]  # per rollout
    realizations: tuple[Scenario, ...]

    @property
    def num_rollouts(self) -> int:
        return self.capacity.shape[0]


def densify_realizations(
    realizations, incidence, extra_boundaries=()
) -> RealizationBatch:
    """Lower sampled ``Scenario`` realizations onto one dense
    ``[rollouts, phases, edges]`` capacity tensor (see
    ``RealizationBatch``). Rejects realizations carrying cross-traffic
    or straggler events — those need the host event loop
    (``engine="batched"``); capacity phases and churn are the paths the
    device engine lowers."""
    realizations = tuple(realizations)
    if not realizations:
        raise ValueError("densify_realizations needs >= 1 realization")
    ts = [0.0]
    ts.extend(float(t) for t in extra_boundaries)
    for sc in realizations:
        if sc.cross_traffic or sc.stragglers:
            raise ValueError(
                "densify_realizations lowers capacity phases and churn "
                "only; cross-traffic and straggler events need the host "
                "event loop — price this scenario with engine='batched'"
            )
        ts.extend(float(ph.start) for ph in sc.capacity_phases)
        ts.extend(float(c.time) for c in sc.churn)
    ts = [t for t in ts if t >= 0.0 and math.isfinite(t)]
    starts = np.unique(np.asarray(ts, dtype=np.float64))
    num_p = starts.size
    num_e = incidence.num_edges
    caps = np.empty((len(realizations), num_p, num_e), dtype=np.float64)
    grid = starts.tolist()
    for r, sc in enumerate(realizations):
        phases = tuple(
            sorted(sc.capacity_phases, key=lambda ph: ph.start)
        )
        phase_caps = [_phase_capacity_array(incidence, ph) for ph in phases]
        cur = -1
        nxt = 0
        for p, t in enumerate(grid):
            # Latest phase with start <= t — the numpy loop's rule.
            while nxt < len(phases) and phases[nxt].start <= t:
                cur = nxt
                nxt += 1
            caps[r, p] = (
                phase_caps[cur] if cur >= 0 else incidence.base_capacity
            )
    return RealizationBatch(
        starts=starts,
        capacity=caps,
        churn=tuple(sc.churn for sc in realizations),
        realizations=realizations,
    )
