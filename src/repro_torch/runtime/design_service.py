"""Design-as-a-service: a long-lived incremental-redesign loop.

A production deployment of the paper's pipeline does not re-run a
490-second design sweep per network event — it *amends* the incumbent
design. ``DesignService`` ingests a replayable stream of events
(``runtime/events.py``) and, per event, picks the cheapest sound
response:

  * **absorb**   — the change touches no category member edge (edges no
    overlay path traverses never constrain, Definition 1), so the
    incumbent design, τ, and every compiled structure are provably
    unchanged: O(changed edges) bookkeeping.
  * **patch**    — capacities of member edges moved but realized τ stays
    within ``drift_band`` of the value at adoption: re-derive only the
    touched C_F (``patch_categories_capacity``), patch the κ/C_F
    coefficients (``patch_category_incidence``) and the simulator's
    capacity vector (``BranchIncidence.with_capacities``) in place —
    every patched structure re-validates under ``REPRO_VALIDATE=1`` —
    and keep the incumbent.
  * **defer / adopt** — τ drifted past the band: price a redesign by
    warm-starting FMMD-P from the incumbent ``_PriorityState``
    (``reset`` rebinds it to the patched incidence, skipping the
    atom→category flattening) and price the *transition* (the
    in-flight round simulated on the patched incidence). Adopt only
    when projected savings beat the transition cost; otherwise defer.
  * **redesign** — membership changed (leave/join): regroup categories
    from the cached shortest-path pairs (no routing recomputation;
    bitwise-identical to rebuilding the overlay from scratch) and run a
    mandatory redesign.

Robustness is first-class. Every pricing attempt runs under an optional
``FaultInjector`` (``runtime/faultinject.py``) with bounded
deterministic retry-with-backoff on a **virtual clock** (no wall-clock
reads, per the determinism lint), and failures degrade through explicit
tiers rather than crashing the loop:

  * ``incumbent-keep``   — redesign failed after retries: keep (or, on a
    departure, renormalize) the incumbent design; revert a failed join.
  * ``scratch-rebuild``  — an incremental patch tripped a
    ``ContractViolation``: distrust the cached structures and rebuild
    overlay + categories + design from scratch.
  * ``quarantine``       — a malformed event with an attributable origin
    quarantines that reporter; its later events are logged-and-dropped.

Every event produces exactly one ``ServiceRecord`` in the ``ServiceLog``
(zero dropped events), so tests assert the decision trail directly.

The port's copy of the JAX package's ``runtime/design_service.py``. The
decisions, tiers, records and τ are the reference's; the service takes a
``device`` for the ``"torch"`` pricing engine and for FMMD's weight
optimization (``None`` means CUDA). The port's sources hold no ``try``
statement (so that no kernel launch can fall back quietly), so the
degradation tiers catch their two exception types of the service's own,
``PricingFault`` and ``ContractViolation``, through ``_Caught``; every
other exception, a failed launch among them, passes through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.analysis.contracts import ContractViolation
from repro_torch.core.fmmd import _PriorityState, fmmd
from repro_torch.net.categories import (
    Categories,
    _group_category_pairs,
    category_entry_order,
    compile_category_incidence,
    compute_categories,
    edge_category_index,
    patch_categories_capacity,
    patch_category_incidence,
)
from repro_torch.net.demands import demands_from_links
from repro_torch.net.routing import RoutingSolution, route_direct
from repro_torch.net.simulator import _ENGINES, compile_incidence, simulate
from repro_torch.net.topology import OverlayNetwork, build_overlay
from repro_torch.runtime.events import (
    AgentJoin,
    AgentLeave,
    LinkStateChange,
    event_sort_key,
    malformed_reason,
)
from repro_torch.runtime.faultinject import FaultInjector, PricingFault
from repro_torch.runtime.fault_tolerance import failure_scenario
from repro_torch.runtime.stragglers import renormalized_mixing


class _Caught:
    """``with _Caught(T) as c:`` runs its block and, if it raises an
    exception of a type in ``T``, stops there and keeps it in ``c.error``
    (None otherwise) — the ``except T`` clauses of the reference. Any
    other exception propagates."""

    def __init__(self, *types: type[BaseException]):
        self.types = types
        self.error: BaseException | None = None

    def __enter__(self) -> "_Caught":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and issubclass(exc_type, self.types):
            self.error = exc
            return True
        return False


class VirtualClock:
    """Deterministic service time: advanced by events and backoffs, never
    read from the wall (the determinism lint forbids wall-clock reads in
    runtime/)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("virtual clock cannot run backwards")
        self._t += float(seconds)

    def advance_to(self, t: float) -> None:
        if t > self._t:
            self._t = float(t)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the incremental-redesign policy.

    ``design_iterations=None`` uses the pipeline default ``max(2m, 4)``
    (pass a small explicit budget at scale). ``drift_band`` is the
    relative τ corridor around the value at adoption inside which a
    capacity patch keeps the incumbent without re-pricing; drifting out
    in *either* direction (degradation or significant recovery)
    triggers pricing. Adoption requires projected savings
    ``horizon_rounds·(τ_now − τ_cand)`` to exceed the transition bill
    ``transition_rounds·τ_transition``. Retries back off
    ``backoff_base·backoff_factor^attempt`` virtual seconds.

    ``engine`` selects the fluid simulator used for amendment/transition
    pricing (any name ``repro_torch.net.simulator.simulate`` accepts).
    Leave transitions always price on ``"batched"``: their mid-round
    departure is a straggler scenario, which the torch engine refuses.

    Engine / scenario / stochastic matrix (service pricing calls)::

        engine=       scenario= (service-built)     stochastic=
        ------------  ----------------------------  -------------------------
        "batched"     full — amendment, drift, and  n/a — the service prices
                      leave-transition pricing      deterministic event
                      (straggler scenario)          streams; Monte-Carlo
        "vectorized"  full (same as "batched")      pricing lives in
        "reference"   RAISES when an event needs    ``evaluate_design(
                      scenario pricing or a         stochastic=...)`` /
                      precompiled incidence         ``StochasticTau.price``
        "torch"       amendment pricing only        (both honor this
                      (capacity phases + churn) on  ``engine``)
                      the service's ``device``;
                      leave transitions still
                      price on "batched" (the torch
                      engine raises on straggler
                      events)

        ``__post_init__`` RAISES on any engine name ``simulate`` does
        not accept.
    """

    design_iterations: int | None = None
    weight_opt: bool = False
    engine: str = "batched"
    drift_band: float = 0.05
    horizon_rounds: float = 50.0
    transition_rounds: float = 1.0
    max_retries: int = 2
    backoff_base: float = 0.5
    backoff_factor: float = 2.0
    price_transitions: bool = True

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(
                f"unknown pricing engine {self.engine!r}: valid engines "
                f"are {', '.join(repr(e) for e in _ENGINES)}"
            )
        if self.drift_band < 0:
            raise ValueError("drift_band must be nonnegative")
        if self.max_retries < 0:
            raise ValueError("max_retries must be nonnegative")
        if self.backoff_base < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff must be nonnegative, factor >= 1")


@dataclasses.dataclass(frozen=True)
class ServiceRecord:
    """One event, one record — the auditable decision trail."""

    seq: int  # position in the ingested stream
    time: float  # event time (virtual seconds)
    event: str  # event kind
    decision: str  # absorb|patch|defer|adopt|redesign|scratch-rebuild|
    #               quarantine|drop|reject
    tier: str  # normal|incumbent-keep|scratch-rebuild|quarantine
    tau: float  # deployed τ after the event
    detail: str = ""
    retries: int = 0
    faults: tuple[str, ...] = ()


class ServiceLog:
    """Append-only record list with decision/tier tallies."""

    def __init__(self):
        self.records: list[ServiceRecord] = []

    def append(self, rec: ServiceRecord) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def _tally(self, field: str) -> dict[str, int]:
        counts: dict[str, int] = {}
        for r in self.records:
            k = getattr(r, field)
            counts[k] = counts.get(k, 0) + 1
        return counts

    @property
    def decisions(self) -> dict[str, int]:
        return self._tally("decision")

    @property
    def tiers(self) -> dict[str, int]:
        return self._tally("tier")

    @property
    def fault_count(self) -> int:
        return sum(len(r.faults) for r in self.records)


@dataclasses.dataclass(frozen=True)
class DesignCandidate:
    """A priced redesign proposal. ``epoch`` stamps the service state it
    was computed against — a stale-cache fault from an earlier epoch is
    detected by the mismatch and retried."""

    epoch: int
    matrix: np.ndarray
    links: tuple
    tau: float  # realized τ of the candidate (closed form, Lemma III.2)
    transition_tau: float  # in-flight-round makespan under the switch
    routing: RoutingSolution


def _poison(cand: DesignCandidate) -> DesignCandidate:
    """The injector's ``nan`` corruption: a numerically-poisoned τ."""
    return dataclasses.replace(cand, tau=float("nan"))


class DesignService:
    """The long-lived loop. Construct from a designed overlay, then feed
    events through ``process``/``run``. See the module docstring for the
    decision policy; all state below is derived from three primaries —
    the membership (stable integer handles → underlay nodes), the cached
    shortest paths per handle pair, and the per-edge capacity scale map
    — so every structure can be re-derived from scratch when a contract
    trips.

    ``device`` is where ``engine="torch"`` prices and where FMMD's weight
    optimization runs when ``config.weight_opt``: ``None`` means CUDA
    (``NoCudaDeviceError`` without a card), ``"cpu"`` runs it here.
    """

    def __init__(
        self,
        overlay: OverlayNetwork,
        kappa: float,
        config: ServiceConfig | None = None,
        clock: VirtualClock | None = None,
        fault_injector: FaultInjector | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = compat.resolve_device(device)
        self.config = config or ServiceConfig()
        self.kappa = float(kappa)
        self.clock = clock or VirtualClock()
        self.injector = fault_injector
        if self.injector is not None and self.injector._clock is None:
            self.injector._clock = self.clock
        self.log = ServiceLog()
        self._seq = 0
        self._epoch = 0
        self._underlay = overlay.underlay
        self._scale: dict[tuple[int, int], float] = {}
        self._quarantined: set[int] = set()
        # Membership: stable handles, initialized to agent indices.
        self._handles: list[int] = list(range(overlay.num_agents))
        self._next_handle = overlay.num_agents
        self._node_of: dict[int, int] = {
            h: overlay.agents[h] for h in self._handles
        }
        # Path cache, keyed (ha, hb) with ha < hb: exactly the paths
        # ``build_overlay`` would recompute, so regrouping from the
        # cache is bitwise-identical to rebuilding the overlay.
        self._pairs: dict[tuple[int, int], tuple[int, ...]] = {}
        m = overlay.num_agents
        for i in range(m):
            for j in range(i + 1, m):
                self._pairs[(i, j)] = overlay.path(i, j)
        self._rebuild_structure()
        self._cold_redesign()

    # -- derived-state maintenance ------------------------------------

    def _cap_of(self, u: int, v: int) -> float:
        key = (u, v) if u < v else (v, u)
        return self._underlay.capacity(u, v) * self._scale.get(key, 1.0)

    def _positions(self) -> dict[int, int]:
        return {h: p for p, h in enumerate(self._handles)}

    @property
    def num_agents(self) -> int:
        return len(self._handles)

    @property
    def members(self) -> tuple[int, ...]:
        return tuple(self._handles)

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def design(self) -> np.ndarray:
        return self._design

    @property
    def categories(self) -> Categories:
        return self._cats

    @property
    def tau(self) -> float:
        return self._tau

    @property
    def quarantined(self) -> tuple[int, ...]:
        return tuple(sorted(self._quarantined))

    def _rebuild_structure(self) -> None:
        """Regroup categories + recompile incidences from the cached
        paths under the current scale map — no path recomputation."""
        handles = self._handles
        m = len(handles)
        pos = self._positions()
        self._overlay = OverlayNetwork(
            underlay=self._underlay,
            agents=tuple(self._node_of[h] for h in handles),
            paths={
                (pos[a], pos[b]): p
                for (a, b), p in self._pairs.items()
            },
        )
        link_arr, eu, ev, rank = self._overlay.batched_path_edges()
        self._cats = _group_category_pairs(
            m, link_arr, eu, ev, rank, self._cap_of
        )
        self._inc = compile_category_incidence(self._cats, m, self.kappa)
        self._edge_index = edge_category_index(self._cats)
        self._entry_order = category_entry_order(self._inc)
        self._prio = (
            _PriorityState(
                [(i, j) for i in range(m) for j in range(i + 1, m)],
                m,
                self._cats,
                self.kappa,
                incidence=self._inc,
            )
            if m >= 2
            else None
        )
        self._epoch += 1

    def _rebuild_from_scratch(self) -> None:
        """Scratch-rebuild degradation tier: distrust every cached
        structure and re-derive overlay + categories from the primaries
        (membership, scale map) via the full pipeline."""
        und = self._underlay
        if self._scale:
            und = self._underlay.with_scaled_capacities(
                {k: s for k, s in sorted(self._scale.items())}
            )
        ov = build_overlay(
            und, [self._node_of[h] for h in self._handles]
        )
        # Re-prime the path cache from the rebuilt overlay (hop-count
        # paths are capacity-independent, but the cache is now untrusted).
        pos_to_handle = dict(enumerate(self._handles))
        self._pairs = {
            (pos_to_handle[i], pos_to_handle[j]): ov.path(i, j)
            for (i, j) in ov.overlay_links
        }
        m = ov.num_agents
        self._overlay = OverlayNetwork(
            underlay=self._underlay,
            agents=ov.agents,
            paths=dict(ov.paths),
        )
        self._cats = compute_categories(ov)
        self._inc = compile_category_incidence(self._cats, m, self.kappa)
        self._edge_index = edge_category_index(self._cats)
        self._entry_order = category_entry_order(self._inc)
        self._prio = (
            _PriorityState(
                [(i, j) for i in range(m) for j in range(i + 1, m)],
                m,
                self._cats,
                self.kappa,
                incidence=self._inc,
            )
            if m >= 2
            else None
        )
        self._epoch += 1

    def _design_once(self) -> tuple[np.ndarray, tuple]:
        """One FMMD-P run on the current structures (warm when the
        priority state exists — ``reset`` makes warm bitwise-equal to
        cold, property-tested)."""
        m = self.num_agents
        iters = self.config.design_iterations or max(2 * m, 4)
        if self._prio is not None:
            self._prio.reset(self._inc)
        res = fmmd(
            m,
            iters,
            categories=self._cats,
            kappa=self.kappa,
            weight_opt=self.config.weight_opt,
            priority=True,
            incidence=self._inc,
            warm_state=self._prio,
            device=self.device,
        )
        return res.matrix, res.activated_links

    def _deploy(self, matrix: np.ndarray, links: tuple,
                routing: RoutingSolution | None = None) -> None:
        """Install a design: route it, compile + capacity-patch the
        branch incidence, refresh the deployed-τ bookkeeping."""
        m = self.num_agents
        self._design = matrix
        self._links = tuple(links)
        if routing is None:
            routing = route_direct(
                demands_from_links(self._links, self.kappa, m),
                self._cats,
                self.kappa,
            )
        self._routing = routing
        if routing.demands:
            binc = compile_incidence(routing, self._overlay)
            if self._scale:
                binc = binc.with_capacities(self._scaled_directed_caps())
            self._binc = binc
            self._loads = self._inc.loads_from_uses(routing.link_uses())
        else:
            self._binc = None
            self._loads = np.zeros(self._inc.num_categories)
        self._tau = self._inc.completion_time(self._loads)
        self._tau_adopt = self._tau

    def _cold_redesign(self) -> None:
        m = self.num_agents
        if m <= 1:
            self._design = np.ones((m, m))
            self._links = ()
            self._routing = None
            self._binc = None
            self._loads = np.zeros(self._inc.num_categories)
            self._tau = 0.0
            self._tau_adopt = 0.0
            return
        matrix, links = self._design_once()
        self._deploy(matrix, links)

    def _scaled_directed_caps(self) -> dict[tuple[int, int], float]:
        """Directed absolute capacities of every currently-scaled edge —
        what ``BranchIncidence.with_capacities`` consumes."""
        caps: dict[tuple[int, int], float] = {}
        for (u, v), s in sorted(self._scale.items()):
            c = self._underlay.capacity(u, v) * s
            caps[(u, v)] = c
            caps[(v, u)] = c
        return caps

    # -- pricing with retry / degradation ------------------------------

    def _priced_candidate(self) -> DesignCandidate:
        matrix, links = self._design_once()
        m = self.num_agents
        routing = route_direct(
            demands_from_links(links, self.kappa, m),
            self._cats,
            self.kappa,
        )
        ttrans = float("nan")
        if (
            self.config.price_transitions
            and self._routing is not None
            and self._routing.demands
            and self._binc is not None
        ):
            # The transition price: the round in flight completes on
            # the *patched* capacities before the new design takes over.
            sim = simulate(
                self._routing, self._overlay, incidence=self._binc,
                engine=self.config.engine, device=self.device,
            )
            ttrans = float(sim.makespan)
        return DesignCandidate(
            epoch=self._epoch,
            matrix=matrix,
            links=links,
            tau=float(routing.completion_time),
            transition_tau=ttrans,
            routing=routing,
        )

    def _attempt_redesign(
        self,
    ) -> tuple[DesignCandidate | None, int, tuple[str, ...]]:
        """Bounded retry-with-backoff around one priced redesign.

        Returns ``(candidate, retries, fault_descriptions)`` with
        ``candidate=None`` when every attempt failed — the caller picks
        the degradation tier.
        """
        cfg = self.config
        faults: list[str] = []
        delay = cfg.backoff_base
        for attempt in range(cfg.max_retries + 1):
            with _Caught(PricingFault) as caught:
                if self.injector is not None:
                    cand = self.injector.call(
                        self._priced_candidate, poison=_poison
                    )
                else:
                    cand = self._priced_candidate()
                if cand.epoch != self._epoch:
                    raise PricingFault(
                        f"stale candidate: epoch {cand.epoch} != "
                        f"{self._epoch}"
                    )
                if not math.isfinite(cand.tau) or not np.all(
                    np.isfinite(cand.matrix)
                ):
                    raise PricingFault("poisoned candidate (non-finite)")
            if caught.error is None:
                return cand, attempt, tuple(faults)
            faults.append(f"attempt {attempt}: {caught.error}")
            if attempt < cfg.max_retries:
                self.clock.advance(delay)
                delay *= cfg.backoff_factor
        return None, cfg.max_retries, tuple(faults)

    # -- event handlers ------------------------------------------------

    def _event_time(self, ev) -> float:
        t = getattr(ev, "time", None)
        if isinstance(t, (int, float)) and math.isfinite(t):
            return float(t)
        return self.clock.now()  # malformed time: stamp with service time

    def _record(self, ev, decision: str, tier: str = "normal",
                detail: str = "", retries: int = 0,
                faults: tuple[str, ...] = ()) -> ServiceRecord:
        rec = ServiceRecord(
            seq=self._seq,
            time=self._event_time(ev),
            event=type(ev).__name__,
            decision=decision,
            tier=tier,
            tau=self._tau,
            detail=detail,
            retries=retries,
            faults=faults,
        )
        self.log.append(rec)
        self._seq += 1
        return rec

    def process(self, ev) -> ServiceRecord:
        """Ingest one event; always returns (and logs) exactly one
        record — the zero-dropped-events contract."""
        self.clock.advance_to(self._event_time(ev))
        origin = getattr(ev, "origin", None)
        if origin is not None and origin in self._quarantined:
            return self._record(
                ev, "drop", tier="quarantine",
                detail=f"origin {origin} is quarantined",
            )
        reason = malformed_reason(ev)
        if reason is not None:
            if origin is not None:
                self._quarantined.add(origin)
                return self._record(
                    ev, "quarantine", tier="quarantine",
                    detail=f"malformed ({reason}); origin {origin} "
                    "quarantined",
                )
            return self._record(
                ev, "reject", tier="quarantine",
                detail=f"malformed ({reason}); no attributable origin",
            )
        if isinstance(ev, LinkStateChange):
            return self._on_link_state(ev)
        if isinstance(ev, AgentLeave):
            return self._on_leave(ev)
        if isinstance(ev, AgentJoin):
            return self._on_join(ev)
        return self._record(  # pragma: no cover - malformed_reason gates
            ev, "reject", tier="quarantine", detail="unhandled event"
        )

    def run(self, events: Sequence) -> ServiceLog:
        """Replay an event stream (sorted by ``event_sort_key``)."""
        for ev in sorted(events, key=event_sort_key):
            self.process(ev)
        return self.log

    # LinkStateChange ---------------------------------------------------

    def _on_link_state(self, ev: LinkStateChange) -> ServiceRecord:
        unknown = [
            e for e in ev.scales if not self._underlay.graph.has_edge(*e)
        ]
        if unknown:
            detail = f"scales name non-underlay edges {unknown[:4]}"
            if ev.origin is not None:
                self._quarantined.add(ev.origin)
                return self._record(
                    ev, "quarantine", tier="quarantine",
                    detail=f"{detail}; origin {ev.origin} quarantined",
                )
            return self._record(
                ev, "reject", tier="quarantine", detail=detail
            )
        changed: dict[tuple[int, int], float] = {}
        for e, s in ev.scales.items():
            key = (e[0], e[1]) if e[0] < e[1] else (e[1], e[0])
            s = float(s)
            if s != self._scale.get(key, 1.0):
                changed[key] = s
        if not changed:
            return self._record(ev, "absorb", detail="no scale moved")
        for key, s in sorted(changed.items()):
            if s == 1.0:
                self._scale.pop(key, None)
            else:
                self._scale[key] = s
        # Directed member edges touched; non-traversed edges belong to
        # no category (Definition 1) and provably change nothing.
        member_caps: dict[tuple[int, int], float] = {}
        directed_caps: dict[tuple[int, int], float] = {}
        edge_cap = self._cats.edge_capacity or {}
        for key, s in sorted(changed.items()):
            for d in (key, (key[1], key[0])):
                c = self._underlay.capacity(*d) * s
                directed_caps[d] = c
                if d in edge_cap:
                    member_caps[d] = c
        if not member_caps:
            return self._record(
                ev, "absorb",
                detail=f"{len(changed)} edge(s) moved, none traversed",
            )
        with _Caught(ContractViolation) as caught:
            cats, touched = patch_categories_capacity(
                self._cats, member_caps, self._edge_index
            )
            inc = patch_category_incidence(
                self._inc, cats, touched, self._entry_order
            )
            binc = (
                self._binc.with_capacities(directed_caps)
                if self._binc is not None
                else None
            )
        if caught.error is not None:
            self._rebuild_from_scratch()
            self._cold_redesign()
            return self._record(
                ev, "scratch-rebuild", tier="scratch-rebuild",
                detail=f"incremental patch tripped contract: {caught.error}",
            )
        self._cats, self._inc, self._binc = cats, inc, binc
        self._epoch += 1  # capacity state moved: older candidates stale
        if self._prio is not None:
            self._prio.reset(self._inc)
        tau_now = self._inc.completion_time(self._loads)
        self._tau = tau_now
        band = self.config.drift_band * self._tau_adopt
        if abs(tau_now - self._tau_adopt) <= band:
            return self._record(
                ev, "patch",
                detail=f"{touched.size} categor(ies) re-bottlenecked, "
                f"tau within band",
            )
        cand, retries, faults = self._attempt_redesign()
        if cand is None:
            return self._record(
                ev, "incumbent-keep", tier="incumbent-keep",
                detail="redesign failed after retries; incumbent kept",
                retries=retries, faults=faults,
            )
        saving = self.config.horizon_rounds * (tau_now - cand.tau)
        cost = self.config.transition_rounds * (
            cand.transition_tau if math.isfinite(cand.transition_tau)
            else 0.0
        )
        if saving <= cost:
            return self._record(
                ev, "defer",
                detail=f"saving {saving:.3g} <= transition {cost:.3g}",
                retries=retries, faults=faults,
            )
        self._deploy(cand.matrix, cand.links, routing=cand.routing)
        return self._record(
            ev, "adopt",
            detail=f"tau {tau_now:.3g} -> {self._tau:.3g}, "
            f"transition {cost:.3g}",
            retries=retries, faults=faults,
        )

    # AgentLeave --------------------------------------------------------

    def _on_leave(self, ev: AgentLeave) -> ServiceRecord:
        h = ev.agent
        if h not in self._node_of:
            if ev.origin is not None:
                self._quarantined.add(ev.origin)
                return self._record(
                    ev, "quarantine", tier="quarantine",
                    detail=f"leave for unknown agent {h}; origin "
                    f"{ev.origin} quarantined",
                )
            return self._record(
                ev, "reject", tier="quarantine",
                detail=f"leave for unknown agent {h}",
            )
        if len(self._handles) == 1:
            return self._record(
                ev, "reject", tier="quarantine",
                detail="last agent cannot leave",
            )
        old_w = self._design
        old_routing, old_binc = self._routing, self._binc
        old_overlay = self._overlay
        keep_pos = [
            p for p, hh in enumerate(self._handles) if hh != h
        ]
        gone_pos = self._handles.index(h)
        self._handles.remove(h)
        del self._node_of[h]
        self._pairs = {
            (a, b): p
            for (a, b), p in self._pairs.items()
            if a != h and b != h
        }
        with _Caught(ContractViolation) as caught:
            self._rebuild_structure()
        if caught.error is not None:
            self._rebuild_from_scratch()
        m = self.num_agents
        if m == 1:
            self._cold_redesign()
            return self._record(
                ev, "redesign",
                detail="single survivor: identity design",
            )
        ttrans = self._price_leave_transition(
            old_routing, old_binc, old_overlay, gone_pos
        )
        cand, retries, faults = self._attempt_redesign()
        if cand is not None:
            self._deploy(cand.matrix, cand.links, routing=cand.routing)
            return self._record(
                ev, "redesign",
                detail=f"agent {h} left; transition {ttrans:.3g}",
                retries=retries, faults=faults,
            )
        # Degradation: shrink the incumbent — drop the departed row and
        # push the lost mass back to the diagonal (doubly stochastic).
        w_eff = renormalized_mixing(
            old_w[np.ix_(keep_pos, keep_pos)],
            np.ones((m, m), dtype=bool),
        )
        links = tuple(
            (i, j)
            for i in range(m)
            for j in range(i + 1, m)
            if w_eff[i, j] > 1e-12
        )
        self._deploy(w_eff, links)
        return self._record(
            ev, "incumbent-keep", tier="incumbent-keep",
            detail=f"redesign failed; incumbent renormalized over "
            f"{m} survivors",
            retries=retries, faults=faults,
        )

    def _price_leave_transition(
        self, old_routing, old_binc, old_overlay, gone_pos: int
    ) -> float:
        """The in-flight round under the departure (transition
        pricing): the departed agent's exchanges cancel mid-round."""
        if (
            not self.config.price_transitions
            or old_routing is None
            or not old_routing.demands
            or old_binc is None
        ):
            return float("nan")
        tau0 = max(float(old_routing.completion_time), 1e-9)
        # Stays on "batched" regardless of config.engine: the departure
        # is modeled as a mid-round straggler, which the torch engine
        # refuses.
        sim = simulate(
            old_routing,
            old_overlay,
            scenario=failure_scenario({gone_pos: 0.5 * tau0}),
            incidence=old_binc,
        )
        return float(sim.makespan)

    # AgentJoin ---------------------------------------------------------

    def _on_join(self, ev: AgentJoin) -> ServiceRecord:
        node = ev.node
        if node not in self._underlay.graph.nodes:
            return self._record(
                ev, "reject", tier="quarantine",
                detail=f"join on unknown underlay node {node}",
            )
        if node in {self._node_of[h] for h in self._handles}:
            return self._record(
                ev, "reject", tier="quarantine",
                detail=f"node {node} already hosts an agent",
            )
        snapshot = self._snapshot()
        h = self._next_handle
        self._next_handle += 1
        for a in list(self._handles):
            self._pairs[(a, h)] = self._underlay.shortest_path(
                self._node_of[a], node
            )
        self._handles.append(h)
        self._node_of[h] = node
        with _Caught(ContractViolation) as caught:
            self._rebuild_structure()
        if caught.error is not None:
            self._rebuild_from_scratch()
        ttrans = float("nan")
        if (
            self.config.price_transitions
            and snapshot["routing"] is not None
            and snapshot["routing"].demands
            and snapshot["binc"] is not None
        ):
            sim = simulate(
                snapshot["routing"],
                snapshot["overlay"],
                incidence=snapshot["binc"],
                engine=self.config.engine,
                device=self.device,
            )
            ttrans = float(sim.makespan)
        cand, retries, faults = self._attempt_redesign()
        if cand is not None:
            self._deploy(cand.matrix, cand.links, routing=cand.routing)
            return self._record(
                ev, "redesign",
                detail=f"agent {h} joined on node {node}; transition "
                f"{ttrans:.3g}",
                retries=retries, faults=faults,
            )
        self._restore(snapshot)
        return self._record(
            ev, "incumbent-keep", tier="incumbent-keep",
            detail=f"join of node {node} reverted: redesign failed "
            "after retries",
            retries=retries, faults=faults,
        )

    # -- snapshot / restore (join revert) -------------------------------

    def _snapshot(self) -> dict:
        return {
            "handles": list(self._handles),
            "next_handle": self._next_handle,
            "node_of": dict(self._node_of),
            "pairs": dict(self._pairs),
            "overlay": self._overlay,
            "cats": self._cats,
            "inc": self._inc,
            "edge_index": self._edge_index,
            "entry_order": self._entry_order,
            "prio": self._prio,
            "design": self._design,
            "links": self._links,
            "routing": self._routing,
            "binc": self._binc,
            "loads": self._loads,
            "tau": self._tau,
            "tau_adopt": self._tau_adopt,
            "epoch": self._epoch,
        }

    def _restore(self, s: dict) -> None:
        self._handles = s["handles"]
        self._next_handle = s["next_handle"]
        self._node_of = s["node_of"]
        self._pairs = s["pairs"]
        self._overlay = s["overlay"]
        self._cats = s["cats"]
        self._inc = s["inc"]
        self._edge_index = s["edge_index"]
        self._entry_order = s["entry_order"]
        self._prio = s["prio"]
        self._design = s["design"]
        self._links = s["links"]
        self._routing = s["routing"]
        self._binc = s["binc"]
        self._loads = s["loads"]
        self._tau = s["tau"]
        self._tau_adopt = s["tau_adopt"]
        # A fresh epoch, not the snapshot's: candidates priced against
        # the aborted membership must read as stale.
        self._epoch += 1
