"""Joint design pipeline — the paper's full system (objective (15)).

Given an overlay (or just its inferred categories), a model size κ, and
convergence constants, produce:

  1. a mixing matrix W (FMMD-WP by default, or a named baseline),
  2. an optimal overlay routing for the demands W triggers (MILP (8)/(12)
     or the congestion-aware heuristic),
  3. per-iteration time τ (routed) and τ̄ (default paths), ρ(W), K(ρ),
     and the estimated total training time τ·K.

``sweep_iterations`` searches the FMMD iteration count T — the outer
knob trading per-iteration cost against convergence speed.

The port's own copy of the JAX package's ``core/designer.py``. The device
engine is ``engine="torch"`` (the reference's ``"jax"``): stochastic
pricing then runs every rollout in one pass of ``net/torch_engine.py``
on ``device``, and ``device`` is also where the weight optimizations of
the designs run (``None`` means CUDA; the tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, MutableMapping, Sequence

import numpy as np
import torch

from repro_torch.core import mixing
from repro_torch.core.fmmd import FMMDResult, fmmd, fmmd_wp, _tau_bar
from repro_torch.core.priced_training import _device_incidence_for
from repro_torch.core.sca import sca_design
from repro_torch.core.topology_baselines import (
    clique_design,
    prim_design,
    ring_design,
)
from repro_torch.net.categories import (
    Categories,
    CategoryIncidence,
    compile_category_incidence,
    compute_categories,
)
from repro_torch.net.demands import demands_from_links
from repro_torch.net.routing import (
    PhasedRoutingSolution,
    RoutingSolution,
    route,
    route_direct,
    route_time_expanded,
)
from repro_torch.net.simulator import (
    Scenario,
    SimResult,
    simulate,
    simulate_phased,
)
from repro_torch.net.stochastic import StochasticScenario
from repro_torch.net.topology import OverlayNetwork


@dataclasses.dataclass(frozen=True)
class DesignOutcome:
    design: FMMDResult
    routing: RoutingSolution
    tau: float           # routed per-iteration time (optimal scheme)
    tau_bar: float       # default-path per-iteration time (eq. 22)
    rho: float
    iterations_to_eps: float
    total_time: float    # τ · K(ρ) — objective (15)
    sim: SimResult | None = None  # static schedule under the scenario
    # Phase-adaptive (time-expanded) schedule, when priced alongside the
    # static one via ``reroute_per_phase=True``:
    phased_routing: PhasedRoutingSolution | None = None
    sim_phased: SimResult | None = None
    tau_static_sched: float = float("nan")  # simulated τ, static schedule
    tau_phased: float = float("nan")        # simulated τ, phased schedule
    # Stochastic pricing (``stochastic=`` + ``stochastic_rollouts=N``):
    # per-rollout simulated τ of the deployed schedule (online re-routed
    # when ``reroute_per_phase``, else static), its seeded mean — which
    # ``tau``/``total_time`` then price — and the p95/p99 tails (p99 is
    # only meaningful at the 256+ rollout budgets ``engine="torch"``
    # makes affordable; at N=8 it ~equals the max sample).
    tau_samples: tuple[float, ...] = ()
    tau_mean: float = float("nan")
    tau_p95: float = float("nan")
    tau_p99: float = float("nan")

    @property
    def name(self) -> str:
        return self.design.variant


def _check_per_edge_scalable(categories: Categories, scenario) -> None:
    """Fail fast — with the fix — when phase-adaptive routing would need
    per-edge capacity scaling that the categories cannot provide.

    ``Categories.scaled`` with a per-edge ``CapacityPhase`` scale
    re-derives C_F from ground-truth member edges and edge capacities;
    inferred categories (``infer_categories``) withhold both, so the
    deep scaling call would raise an unactionable ``ValueError`` from
    inside the routing stack. Catch it at the designer level instead.
    """
    if scenario is None or not getattr(scenario, "capacity_phases", ()):
        return
    if categories.edge_capacity is not None and all(
        categories.members.values()
    ):
        return
    if any(
        isinstance(ph.scale, Mapping) for ph in scenario.capacity_phases
    ):
        raise ValueError(
            "reroute_per_phase with per-edge CapacityPhase scales needs "
            "ground-truth categories: these categories have no member "
            "edges / edge capacities (infer_categories withholds them), "
            "so Categories.scaled cannot re-derive the per-phase C_F. "
            "Either build the categories with compute_categories(overlay) "
            "or restrict the scenario to scalar phase scales."
        )


def evaluate_design(
    design: FMMDResult,
    categories: Categories,
    kappa: float,
    num_agents: int,
    constants: mixing.ConvergenceConstants = mixing.ConvergenceConstants(),
    optimize_routing: bool = True,
    milp_time_limit: float = 60.0,
    overlay: OverlayNetwork | None = None,
    scenario: Scenario | None = None,
    incidence: CategoryIncidence | None = None,
    routing_cache: MutableMapping | None = None,
    heuristic_rounds: int = 8,
    reroute_per_phase: bool = False,
    stochastic: StochasticScenario | None = None,
    stochastic_rollouts: int = 8,
    stochastic_seed: int = 0,
    engine: str = "batched",
    device: str | torch.device | None = None,
) -> DesignOutcome:
    """Route the design's demands and price its total training time.

    With ``scenario`` (and the ``overlay`` it needs), the per-iteration
    time τ is the fluid-simulated makespan under the scenario's degraded
    network instead of the closed-form static value — so a design can be
    priced under time-varying capacities, cross-traffic, stragglers, and
    churn before deployment. Churn-cancelled exchanges are priced as
    renormalized-mixing rounds (the survivors' completion time; see
    ``outcome.sim.cancelled_branches`` for how much of W was lost), while
    a simulation that never completes (``unfinished_branches > 0``) or
    delivers nothing (every flow fully churn-cancelled — all-NaN
    ``flow_completion``) prices as τ = inf rather than silently
    under-counting.

    ``reroute_per_phase=True`` additionally prices the phase-adaptive
    schedule (``route_time_expanded`` against the scenario's capacity
    phases): both schedules are simulated, both τ values land in
    ``tau_static_sched``/``tau_phased`` (with the simulations in
    ``sim``/``sim_phased`` and the schedule in ``phased_routing``), and
    the design is priced at the better of the two — the schedule an
    operator would actually deploy. Requires ``optimize_routing``, and —
    when the scenario's phases carry *per-edge* scale maps — categories
    with ground-truth members/edge capacities (``compute_categories``;
    inferred categories fail fast here with the fix spelled out rather
    than deep inside ``Categories.scaled``).

    ``stochastic`` (a ``StochasticScenario``) prices the design as a
    *seeded expectation*: ``stochastic_rollouts`` realizations are drawn
    with keys ``(stochastic_seed, r)``, each is simulated — with
    ``reroute_per_phase=True`` the deployed schedule is the *online*
    re-router (``route_time_expanded(online=True)``, deciding at every
    boundary from the realized state only), else the static one — and
    ``tau`` becomes the mean over rollouts (``tau_mean``), with the p95
    tail in ``tau_p95`` and every sample in ``tau_samples``. Mutually
    exclusive with ``scenario`` (a stochastic model IS a distribution
    over scenarios); deterministic events ride in ``stochastic.base``.

    ``incidence`` (precompiled ``CategoryIncidence``) and
    ``routing_cache`` (activated-link-set → ``RoutingSolution``;
    phase-adaptive segments under ``(link-set, phase-scale)`` keys)
    amortize routing work across repeated calls with the same
    categories/κ/routing settings — different FMMD iteration counts
    frequently activate the same link set, so a grid sweep rarely
    re-routes; stochastic rollouts reuse it too (recurring Markov states
    re-realize the same per-edge scales).

    ``engine`` selects the simulation engine for every pricing run
    (see ``simulate``). With ``engine="torch"`` the stochastic path
    compiles the branch incidence once per activated-link set (cached
    as a padded ``DeviceIncidence`` in ``routing_cache`` under
    ``("torch-device-incidence", link set)``) and prices ALL
    ``stochastic_rollouts`` in one device pass on ``device`` (``None``
    means CUDA) instead of a Python loop — which is what makes 256+
    rollout budgets (and hence a meaningful ``tau_p99``) practical. The
    torch engine prices the static deployed schedule; combining it with
    ``reroute_per_phase`` (host-side online re-routing) is rejected —
    price that policy with the numpy engines.

    Engine / scenario / stochastic matrix::

        engine=       scenario=                     stochastic=
        ------------  ----------------------------  -------------------------
        "batched"     full (needs ``overlay=``);    host loop over rollouts;
                      ``reroute_per_phase=True``    ``reroute_per_phase``
                      prices the phase-adaptive     deploys the *online*
                      schedule too                  re-router per rollout
        "vectorized"  full (same as "batched")      same host loop
        "reference"   RAISES on any scenario        RAISES (rollouts are
                                                    scenarios)
        "torch"       capacity phases + churn;      ALL rollouts in one device
                      RAISES on cross-traffic /     pass (``DeviceIncidence``
                      stragglers; RAISES with       cached in
                      ``reroute_per_phase=True``    ``routing_cache``); RAISES
                                                    with ``reroute_per_phase``

        Always RAISES: ``scenario=`` and ``stochastic=`` together;
        either without ``overlay=``; ``reroute_per_phase`` without
        ``optimize_routing``; per-edge capacity phases with inferred
        (memberless) categories.
    """
    if (scenario is not None or stochastic is not None) and overlay is None:
        raise ValueError("scenario pricing requires the overlay")
    if scenario is not None and stochastic is not None:
        raise ValueError(
            "pass either a deterministic scenario or a stochastic model, "
            "not both (deterministic events ride in stochastic.base)"
        )
    if stochastic is not None and stochastic_rollouts < 1:
        raise ValueError("stochastic_rollouts must be >= 1")
    if reroute_per_phase and not optimize_routing:
        raise ValueError(
            "reroute_per_phase re-optimizes routing per capacity phase; "
            "it requires optimize_routing=True"
        )
    if engine == "torch" and reroute_per_phase:
        raise ValueError(
            "engine='torch' prices the static deployed schedule on the "
            "device; online per-phase re-routing is host-side — price "
            "reroute_per_phase with engine='batched'"
        )
    if reroute_per_phase:
        _check_per_edge_scalable(categories, scenario)
    links = design.activated_links
    demands = demands_from_links(links, kappa, num_agents) if links else []
    if demands:
        cache_key = frozenset(links)
        sol = (
            routing_cache.get(cache_key)
            if routing_cache is not None else None
        )
        if sol is None:
            if optimize_routing:
                sol = route(
                    demands, categories, kappa, num_agents,
                    time_limit=milp_time_limit, incidence=incidence,
                    heuristic_rounds=heuristic_rounds,
                )
            else:
                sol = route_direct(demands, categories, kappa)
            if routing_cache is not None:
                routing_cache[cache_key] = sol
    else:
        sol = RoutingSolution(
            demands=(), trees=(), completion_time=0.0,
            method="empty", solve_seconds=0.0,
        )

    def _priced_tau(sim: SimResult) -> float:
        # A truncated run, or one where churn cancelled every flow
        # outright (all-NaN completions), must not price as cheap/free.
        undelivered = sim.cancelled_branches > 0 and all(
            np.isnan(c) for c in sim.flow_completion
        )
        return (
            np.inf if sim.unfinished_branches or undelivered
            else sim.makespan
        )

    sim = None
    sim_phased = None
    phased = None
    tau = sol.completion_time
    tau_static_sched = float("nan")
    tau_phased = float("nan")
    tau_samples: tuple[float, ...] = ()
    tau_mean = float("nan")
    tau_p95 = float("nan")
    tau_p99 = float("nan")
    if stochastic is not None and demands and engine == "torch":
        # Deferred import, as the reference defers its device engine.
        from repro_torch.net import torch_engine

        dev = _device_incidence_for(sol, overlay, links, routing_cache)
        batch = stochastic.realization_batch(
            stochastic_seed, stochastic_rollouts, dev.source
        )
        sims = torch_engine.rollout_batch_results(
            sol, dev, batch, device=device
        )
        sim = sims[-1]  # inspection aid, as in the numpy path
        samples = [_priced_tau(s) for s in sims]
        tau_samples = tuple(float(s) for s in samples)
        tau_mean = float(np.mean(samples))
        tau_p95 = float(np.percentile(samples, 95.0))
        tau_p99 = float(np.percentile(samples, 99.0))
        tau = tau_mean
        tau_static_sched = tau_mean
    elif stochastic is not None and demands:
        static_samples = []
        online_samples = []
        for realization in stochastic.sample_many(
            stochastic_seed, stochastic_rollouts
        ):
            sim = simulate(sol, overlay, scenario=realization, engine=engine)
            static_samples.append(_priced_tau(sim))
            if reroute_per_phase and realization.capacity_phases:
                _check_per_edge_scalable(categories, realization)
                # The deployed policy: online re-routing from observed
                # state at every realized phase boundary.
                phased = route_time_expanded(
                    demands, categories, realization, kappa, num_agents,
                    time_limit=milp_time_limit, incidence=incidence,
                    heuristic_rounds=heuristic_rounds,
                    routing_cache=routing_cache,
                    cache_key=frozenset(links), base_solution=sol,
                    online=True, overlay=overlay,
                )
                sim_phased = simulate_phased(
                    phased, overlay, scenario=realization, engine=engine
                )
                online_samples.append(_priced_tau(sim_phased))
            elif reroute_per_phase:
                # Trivial realization: the online schedule degenerates
                # to the static route bitwise — reuse its sample.
                online_samples.append(static_samples[-1])
        # ``sim``/``sim_phased``/``phased_routing`` keep the LAST
        # rollout's artifacts (inspection aids); the pricing is the
        # seeded expectation over all of them.
        samples = online_samples if reroute_per_phase else static_samples
        tau_samples = tuple(float(s) for s in samples)
        tau_mean = float(np.mean(samples))
        tau_p95 = float(np.percentile(samples, 95.0))
        tau_p99 = float(np.percentile(samples, 99.0))
        tau = tau_mean
        tau_static_sched = float(np.mean(static_samples))
        if reroute_per_phase:
            tau_phased = float(np.mean(online_samples))
    elif scenario is not None and demands:
        sim = simulate(
            sol, overlay, scenario=scenario, engine=engine, device=device
        )
        tau = tau_static_sched = _priced_tau(sim)
        if reroute_per_phase and scenario.capacity_phases:
            phased = route_time_expanded(
                demands, categories, scenario, kappa, num_agents,
                time_limit=milp_time_limit, incidence=incidence,
                heuristic_rounds=heuristic_rounds,
                routing_cache=routing_cache, cache_key=frozenset(links),
                base_solution=sol,  # unscaled segments reuse the static route
            )
            sim_phased = simulate_phased(
                phased, overlay, scenario=scenario, engine=engine
            )
            tau_phased = _priced_tau(sim_phased)
            # Deploy whichever schedule the scenario actually favors.
            tau = min(tau_static_sched, tau_phased)
    rho_v = design.rho
    k_eps = mixing.iterations_to_converge(rho_v, num_agents, constants)
    return DesignOutcome(
        design=design,
        routing=sol,
        tau=tau,
        tau_bar=_tau_bar(
            frozenset(links), categories, kappa, incidence=incidence
        ),
        rho=rho_v,
        iterations_to_eps=k_eps,
        total_time=tau * k_eps,
        sim=sim,
        phased_routing=phased,
        sim_phased=sim_phased,
        tau_static_sched=tau_static_sched,
        tau_phased=tau_phased,
        tau_samples=tau_samples,
        tau_mean=tau_mean,
        tau_p95=tau_p95,
        tau_p99=tau_p99,
    )


def design(
    method: str,
    categories: Categories,
    kappa: float,
    num_agents: int,
    overlay: OverlayNetwork | None = None,
    iterations: int = 12,
    constants: mixing.ConvergenceConstants = mixing.ConvergenceConstants(),
    optimize_routing: bool = True,
    scenario: Scenario | None = None,
    milp_time_limit: float = 60.0,
    incidence: CategoryIncidence | None = None,
    routing_cache: MutableMapping | None = None,
    heuristic_rounds: int = 8,
    reroute_per_phase: bool = False,
    stochastic: StochasticScenario | None = None,
    stochastic_rollouts: int = 8,
    stochastic_seed: int = 0,
    engine: str = "batched",
    device: str | torch.device | None = None,
) -> DesignOutcome:
    """Produce and price one named design.

    method ∈ {"fmmd", "fmmd-w", "fmmd-p", "fmmd-wp", "clique", "ring",
              "prim", "sca"}. ``scenario`` prices the design under a
    degraded/time-varying network (requires ``overlay``);
    ``reroute_per_phase`` additionally prices the phase-adaptive
    schedule (see ``evaluate_design``); ``stochastic`` prices it as a
    seeded expectation over ``stochastic_rollouts`` realizations
    (online re-routed when ``reroute_per_phase``);
    ``incidence``/``routing_cache`` amortize routing across repeated
    calls, and ``engine`` selects the simulation engine —
    ``engine="torch"`` batches all rollouts in one device pass (see
    ``evaluate_design``). ``device`` is where the weight optimizations
    and the torch engine run (``None`` means CUDA).
    """
    m = num_agents
    method = method.lower()
    if method == "fmmd":
        d = fmmd(m, iterations)
    elif method == "fmmd-w":
        d = fmmd(m, iterations, weight_opt=True, device=device)
    elif method == "fmmd-p":
        d = fmmd(m, iterations, categories=categories, kappa=kappa,
                 priority=True, incidence=incidence)
    elif method == "fmmd-wp":
        d = fmmd_wp(m, iterations, categories, kappa, incidence=incidence,
                    device=device)
    elif method == "clique":
        d = clique_design(m, device=device)
    elif method == "ring":
        d = ring_design(m, device=device)
    elif method == "prim":
        if overlay is None:
            raise ValueError("prim needs the overlay (path structure)")
        d = prim_design(overlay, device=device)
    elif method == "sca":
        d = sca_design(m, categories, kappa, constants, device=device)
    else:
        raise ValueError(f"unknown design method: {method}")
    return evaluate_design(
        d, categories, kappa, m, constants, optimize_routing,
        milp_time_limit=milp_time_limit, overlay=overlay,
        scenario=scenario, incidence=incidence,
        routing_cache=routing_cache, heuristic_rounds=heuristic_rounds,
        reroute_per_phase=reroute_per_phase,
        stochastic=stochastic,
        stochastic_rollouts=stochastic_rollouts,
        stochastic_seed=stochastic_seed,
        engine=engine,
        device=device,
    )


def sweep_iterations(
    categories: Categories,
    kappa: float,
    num_agents: int,
    iteration_grid: Sequence[int] = (4, 8, 12, 16, 24, 32),
    constants: mixing.ConvergenceConstants = mixing.ConvergenceConstants(),
    method: str = "fmmd-wp",
    overlay: OverlayNetwork | None = None,
    scenario: Scenario | None = None,
    optimize_routing: bool = True,
    milp_time_limit: float = 60.0,
    heuristic_rounds: int = 8,
    reroute_per_phase: bool = False,
    stochastic: StochasticScenario | None = None,
    stochastic_rollouts: int = 8,
    stochastic_seed: int = 0,
    engine: str = "batched",
    device: str | torch.device | None = None,
) -> DesignOutcome:
    """Outer search over the design method's T for the best total time.

    ``overlay``/``scenario`` price every grid point under a degraded or
    time-varying network; ``reroute_per_phase`` prices the
    phase-adaptive schedule alongside the static one at every grid
    point (see ``evaluate_design``); ``stochastic`` prices every grid
    point as a seeded expectation over ``stochastic_rollouts``
    realizations — every point sees the SAME realizations (common
    random numbers), so the T comparison is not confounded by sampling
    noise; ``optimize_routing=False`` skips
    the routing optimizer (default paths only), ``milp_time_limit``
    caps each point's MILP, and ``heuristic_rounds`` tunes the
    congestion-aware re-routing budget. The link×category incidence is
    compiled once and the routing solutions are cached by
    activated-link set — and, for phase-adaptive segments, by
    (activated-link set, phase scale) — so grid points whose designs
    activate the same links are routed exactly once per phase.
    ``engine="torch"`` additionally caches one padded device incidence
    per activated-link set and prices each grid point's rollout batch
    as a single device pass on ``device`` (see ``evaluate_design``).

    Engine / scenario / stochastic matrix (every grid point prices
    through ``evaluate_design``, so its matrix applies verbatim)::

        engine=       scenario=                     stochastic=
        ------------  ----------------------------  -------------------------
        "batched"     full (needs ``overlay=``)     host loop, common random
                                                    numbers across grid points
        "vectorized"  full (same as "batched")      same host loop
        "reference"   RAISES on any scenario        RAISES
        "torch"       capacity phases + churn;      one device pass per grid
                      RAISES on cross-traffic /     point; RAISES with
                      stragglers or                 ``reroute_per_phase=True``
                      ``reroute_per_phase=True``

        Always RAISES: ``scenario=`` with ``stochastic=``; either
        without ``overlay=``; ``reroute_per_phase`` without
        ``optimize_routing``.
    """
    # One compilation serves both the routing heuristic and the FMMD-P
    # priority filter across every grid point.
    incidence = (
        compile_category_incidence(categories, num_agents, kappa)
        if optimize_routing or method.lower() in ("fmmd-p", "fmmd-wp")
        else None
    )
    routing_cache: dict = {}
    best: DesignOutcome | None = None
    for t in iteration_grid:
        out = design(
            method, categories, kappa, num_agents, overlay=overlay,
            iterations=t, constants=constants,
            optimize_routing=optimize_routing, scenario=scenario,
            milp_time_limit=milp_time_limit, incidence=incidence,
            routing_cache=routing_cache,
            heuristic_rounds=heuristic_rounds,
            reroute_per_phase=reroute_per_phase,
            stochastic=stochastic,
            stochastic_rollouts=stochastic_rollouts,
            stochastic_seed=stochastic_seed,
            engine=engine,
            device=device,
        )
        if np.isfinite(out.total_time) and (
            best is None or out.total_time < best.total_time
        ):
            best = out
    if best is None:
        raise RuntimeError("no finite design found; widen iteration_grid")
    return best
