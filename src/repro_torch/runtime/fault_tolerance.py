"""Fault tolerance: agent failure → mixing-matrix re-design → resume.

In D-PSGD a failed agent is not a lost shard of THE model — every agent
holds a full replica — so recovery is a *membership + hyperparameter*
problem, which is exactly what the paper's machinery solves:

  1. detect the failure (missed heartbeats),
  2. drop the agent from the overlay, re-run FMMD-WP on the surviving
     overlay (categories restricted to surviving paths),
  3. re-map the stacked state (checkpoint.restore's elastic agent axis,
     or in-memory row drop), rebuild the gossip schedule, continue.

The same path handles *scale-up* (new agents join, cloned from a current
replica) — elastic scaling. ``FaultToleranceController`` simulates the
control loop; on a real deployment the heartbeat source is the cluster
manager and the step is rebuilt through the launcher.

The port's copy of the JAX package's ``runtime/fault_tolerance.py``:
stacked state is a tree of tensors (``repro_torch.tree``) re-mapped on
the tensors' own device, and the FMMD-WP redesigns take a ``device``
for their weight optimization (``None`` means CUDA).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.fmmd import fmmd_wp
from repro_torch.core.gossip import GossipSchedule, build_schedule
from repro_torch.net.categories import Categories, compute_categories
from repro_torch.net.simulator import ChurnEvent, Scenario, StragglerEvent
from repro_torch.net.topology import OverlayNetwork, build_overlay
from repro_torch.tree import tree_map


@dataclasses.dataclass
class Membership:
    """Live agent set over an (optionally changing) overlay."""

    overlay: OverlayNetwork
    alive: tuple[int, ...]  # agent indices into the ORIGINAL overlay

    def surviving_overlay(self) -> OverlayNetwork:
        nodes = [self.overlay.agents[a] for a in self.alive]
        return build_overlay(self.overlay.underlay, nodes)


def redesign_after_failure(
    overlay: OverlayNetwork,
    alive: tuple[int, ...],
    kappa: float,
    iterations: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, GossipSchedule, Categories]:
    """Re-run the paper's pipeline on the surviving agents (FMMD-WP's
    weight optimization on ``device``; ``None`` means CUDA)."""
    m = len(alive)
    if m == 1:
        # A single survivor has no overlay links, hence no nonempty
        # categories — return the valid empty structure the signature
        # promises (``compute_categories`` on a 1-agent overlay yields
        # exactly this), not None.
        w = np.ones((1, 1))
        return w, build_schedule(w), Categories(
            members={}, capacity={}, edge_capacity={}
        )
    sub = build_overlay(
        overlay.underlay, [overlay.agents[a] for a in alive]
    )
    cats = compute_categories(sub)
    design = fmmd_wp(
        m, iterations or max(2 * m, 4), cats, kappa, device=device
    )
    return design.matrix, build_schedule(design.matrix), cats


def churn_events_from_failures(
    failures: Mapping[int, float]
) -> tuple[ChurnEvent, ...]:
    """Agent → failure-time map as fluid-simulator churn events."""
    return tuple(
        ChurnEvent(agent=a, time=t)
        for a, t in sorted(failures.items(), key=lambda kv: kv[1])
    )


def failure_scenario(
    failures: Mapping[int, float] | None = None,
    pre_failure_slowdown: float = 1.0,
    slowdown_window: float = 0.0,
) -> Scenario:
    """Scenario for pricing a round that loses agents mid-flight.

    Optionally models the common failure signature where an agent limps
    (``pre_failure_slowdown``× for ``slowdown_window`` seconds) before it
    drops out — the pattern ``HeartbeatMonitor`` reacts to.
    """
    failures = dict(failures or {})
    stragglers = []
    if pre_failure_slowdown > 1.0 and slowdown_window > 0.0:
        for agent, t in failures.items():
            stragglers.append(
                StragglerEvent(
                    agent=agent,
                    slowdown=pre_failure_slowdown,
                    start=max(0.0, t - slowdown_window),
                    stop=t,
                )
            )
    return Scenario(
        stragglers=tuple(stragglers),
        churn=churn_events_from_failures(failures),
    )


def shrink_state(
    state: Any, alive: tuple[int, ...], num_agents: int
) -> Any:
    """Drop failed agents' rows from a stacked-agent state tree.

    ``num_agents`` is the CURRENT stacked-agent count: only leaves whose
    leading dimension equals it are sliced. (The previous
    ``x.shape[0] > max(alive)`` heuristic sliced *any* leaf with a large
    enough leading dim — corrupting non-agent leaves such as a
    replicated RNG key of shape [2] or global scalars lifted to 1-D.)
    """
    idx = np.asarray(alive, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= num_agents):
        raise ValueError(
            f"alive indices {alive} out of range for num_agents="
            f"{num_agents}"
        )

    def take(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == num_agents:
            return x[torch.as_tensor(idx, device=x.device)]
        return x

    return tree_map(take, state)


def grow_state(state: Any, new_m: int, clone_from: int = 0) -> Any:
    """Add agents cloned from an existing replica (elastic scale-up).

    As in the reference, EVERY leaf with ``ndim >= 1`` is grown (or cut
    to ``new_m`` rows), whatever its leading dimension means."""

    def grow(x):
        if not hasattr(x, "ndim") or x.ndim < 1:
            return x
        old_m = x.shape[0]
        if new_m <= old_m:
            return x[:new_m]
        reps = x[clone_from : clone_from + 1].repeat_interleave(
            new_m - old_m, dim=0
        )
        return torch.cat([x, reps], dim=0)

    return tree_map(grow, state)


class HeartbeatMonitor:
    """Failure detection by missed heartbeats (simulation-friendly)."""

    def __init__(self, agents: tuple[int, ...], timeout: float = 3.0,
                 now: Callable[[], float] = time.monotonic):
        self._timeout = timeout
        self._now = now
        self._last = {a: now() for a in agents}

    def beat(self, agent: int) -> None:
        self._last[agent] = self._now()

    def failed(self) -> tuple[int, ...]:
        t = self._now()
        return tuple(
            a for a, last in self._last.items() if t - last > self._timeout
        )

    def remove(self, agent: int) -> None:
        self._last.pop(agent, None)


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    failed: tuple[int, ...]
    survivors: tuple[int, ...]
    new_rho: float
    redesign_seconds: float
    # Transition-round pricing: the fluid-simulated makespan of the
    # in-flight round under a failure_scenario for the detected
    # failures, and how many unicast exchanges the departures cancelled.
    # NaN/0 when transition pricing is disabled. ``pricing_seconds``
    # times the pricing itself, kept separate so ``redesign_seconds``
    # stays a pure redesign-cost metric.
    transition_tau: float = float("nan")
    cancelled_exchanges: int = 0
    pricing_seconds: float = 0.0


class FaultToleranceController:
    """Orchestrates detect → price → redesign → shrink for a stacked
    trainer.

    Besides redesigning the mixing matrix for the survivors, the
    controller prices the *transition* round: the round in flight when
    the failure hits is simulated under ``failure_scenario`` (departures
    cancel the affected exchanges mid-round), and the resulting makespan
    and cancelled-exchange count land in the ``RecoveryEvent`` — the
    recovery cost, not just the recovery outcome. Disable with
    ``price_transitions=False`` (e.g. when the controller is driven at
    very high frequency and the extra routing+simulation per failure
    matters).
    """

    def __init__(
        self,
        overlay: OverlayNetwork,
        kappa: float,
        price_transitions: bool = True,
        transition_routing_rounds: int = 2,
        clock: Callable[[], float] = time.perf_counter,
        device: str | torch.device | None = None,
    ):
        self.overlay = overlay
        self.kappa = kappa
        self.alive = tuple(range(overlay.num_agents))
        self.events: list[RecoveryEvent] = []
        self.price_transitions = price_transitions
        self._routing_rounds = transition_routing_rounds
        # Injectable for deterministic tests / the virtual-clock service
        # loop; the default attribute reference is what the determinism
        # lint permits (no direct wall-clock *calls* in handlers).
        self._clock = clock
        self._cur_overlay = overlay
        self._cur_routing = None  # lazily routed per membership epoch
        self.device = device  # FMMD-WP's weight optimization (None: CUDA)

    def _round_routing(self):
        """Routing of the round in flight for the current membership."""
        from repro_torch.net.demands import demands_from_links
        from repro_torch.net.routing import route

        if self._cur_routing is None:
            m = self._cur_overlay.num_agents
            if m < 2:
                return None
            cats = compute_categories(self._cur_overlay)
            design = fmmd_wp(
                m, max(2 * m, 4), cats, self.kappa, device=self.device
            )
            demands = demands_from_links(
                design.activated_links, self.kappa, m
            )
            if demands:
                # Heuristic-only (milp_var_budget=0): the transition
                # price must stay cheap next to the redesign itself.
                self._cur_routing = route(
                    demands, cats, self.kappa, m, milp_var_budget=0,
                    heuristic_rounds=self._routing_rounds,
                )
        return self._cur_routing

    def _price_transition(
        self,
        failed: tuple[int, ...],
        failure_times: Mapping[int, float] | None,
    ) -> tuple[float, int]:
        from repro_torch.net.simulator import simulate

        routing = self._round_routing()
        if routing is None or not routing.demands:
            return float("nan"), 0
        # Agents are re-indexed after each redesign: churn events must
        # address positions within the current membership.
        pos = {a: i for i, a in enumerate(self.alive)}
        tau0 = routing.completion_time
        failures = {
            pos[a]: max(float((failure_times or {}).get(a, 0.5 * tau0)),
                        1e-9)
            for a in failed if a in pos
        }
        if not failures:
            return float("nan"), 0
        sim = simulate(
            routing, self._cur_overlay,
            scenario=failure_scenario(failures),
        )
        return float(sim.makespan), int(sim.cancelled_branches)

    def handle_failures(
        self,
        failed: tuple[int, ...],
        state: Any,
        step: int,
        failure_times: Mapping[int, float] | None = None,
    ) -> tuple[Any, np.ndarray, GossipSchedule]:
        """Price the interrupted round, redesign, and shrink the state.

        ``failure_times`` (original agent index → seconds into the
        in-flight round) refines the transition pricing; failures
        default to the middle of the round.
        """
        from repro_torch.core import mixing as mixing_lib

        survivors = tuple(a for a in self.alive if a not in failed)
        if not survivors:
            raise RuntimeError("all agents failed")
        t_price = self._clock()
        transition_tau, cancelled = (
            self._price_transition(tuple(failed), failure_times)
            if self.price_transitions else (float("nan"), 0)
        )
        t0 = self._clock()  # redesign timing excludes the pricing
        pricing_seconds = t0 - t_price
        # state rows are indexed by position within current alive set
        keep_pos = tuple(
            i for i, a in enumerate(self.alive) if a not in failed
        )
        new_state = shrink_state(state, keep_pos, len(self.alive))
        w, schedule, _ = redesign_after_failure(
            self.overlay, survivors, self.kappa, device=self.device
        )
        self.alive = survivors
        self._cur_overlay = build_overlay(
            self.overlay.underlay,
            [self.overlay.agents[a] for a in survivors],
        )
        self._cur_routing = None  # next failure re-routes the new epoch
        self.events.append(
            RecoveryEvent(
                step=step,
                failed=tuple(failed),
                survivors=survivors,
                new_rho=mixing_lib.rho(w) if w.shape[0] > 1 else 0.0,
                redesign_seconds=self._clock() - t0,
                transition_tau=transition_tau,
                cancelled_exchanges=cancelled,
                pricing_seconds=pricing_seconds,
            )
        )
        return new_state, w, schedule
