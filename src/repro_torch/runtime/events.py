"""Event model for the design-as-a-service loop.

A deployed designer does not see networks — it sees *events*: link
capacities sagging and recovering, agents dropping out, agents asking to
join. This module defines the replayable event vocabulary the
``DesignService`` (``runtime/design_service.py``) ingests, plus the
bridge that turns a sampled ``StochasticScenario`` realization into an
event stream (so the same Markov dynamics that price designs offline
drive the service online).

Every event is a frozen dataclass with a ``time`` (virtual seconds) and
an optional ``origin`` — the agent handle that *reported* the event.
Origins power the quarantine degradation tier: a malformed event with an
attributable origin quarantines that reporter, and later events from a
quarantined origin are logged-and-dropped instead of trusted.

``malformed_reason`` is the structural validator: it returns a human-
readable reason string for events that must not reach the design logic
(non-finite times, non-positive capacity scales, bogus agent ids), or
``None`` for well-formed events. Semantic validation (does this agent
handle exist *right now*?) stays in the service, which owns membership.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from repro_torch.net.stochastic import StochasticScenario, realization_deltas


@dataclasses.dataclass(frozen=True)
class LinkStateChange:
    """Underlay link capacities moved: ``scales`` maps underlay edges
    (either key direction) to their new *absolute* multiplier vs base
    capacity — 1.0 means the edge recovered. Matches the semantics of
    ``CapacityPhase.scale`` maps, so ``realization_deltas`` output feeds
    straight in."""

    time: float
    scales: Mapping[tuple[int, int], float]
    origin: int | None = None


@dataclasses.dataclass(frozen=True)
class AgentLeave:
    """Agent ``agent`` (service handle) departs — churn or failure."""

    time: float
    agent: int
    origin: int | None = None


@dataclasses.dataclass(frozen=True)
class AgentJoin:
    """A new agent asks to join, placed on underlay node ``node``."""

    time: float
    node: int
    origin: int | None = None


Event = LinkStateChange | AgentLeave | AgentJoin

# Deterministic tie-break for same-time events: capacity moves first
# (they are observations about the past interval), then departures, then
# joins. Stable sort preserves stream order within a kind.
_KIND_ORDER = {LinkStateChange: 0, AgentLeave: 1, AgentJoin: 2}


def event_sort_key(ev) -> tuple[float, int]:
    t = getattr(ev, "time", None)
    if not isinstance(t, (int, float)) or not math.isfinite(t):
        t = math.inf  # malformed times sort last; the service rejects them
    return (float(t), _KIND_ORDER.get(type(ev), 99))


def _is_index(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool) and x >= 0


def malformed_reason(ev) -> str | None:
    """Reason string when ``ev`` must not reach the design logic."""
    t = getattr(ev, "time", None)
    if not isinstance(t, (int, float)) or not math.isfinite(t) or t < 0:
        return f"non-finite or negative time {t!r}"
    if isinstance(ev, LinkStateChange):
        if not isinstance(ev.scales, Mapping):
            return "scales is not a mapping"
        for e, s in ev.scales.items():
            if (
                not isinstance(e, tuple)
                or len(e) != 2
                or not all(_is_index(n) for n in e)
            ):
                return f"malformed edge key {e!r}"
            if not isinstance(s, (int, float)) or not math.isfinite(s) \
                    or s <= 0:
                return f"non-positive scale {s!r} for edge {e}"
        return None
    if isinstance(ev, AgentLeave):
        return None if _is_index(ev.agent) else f"bad agent {ev.agent!r}"
    if isinstance(ev, AgentJoin):
        return None if _is_index(ev.node) else f"bad node {ev.node!r}"
    return f"unknown event type {type(ev).__name__}"


def events_from_stochastic(
    sto: StochasticScenario, key
) -> tuple[Event, ...]:
    """Event-source one sampled realization of ``sto``.

    Bitwise-deterministic in ``key`` (inherits ``sample``'s contract):
    each capacity-phase boundary becomes one ``LinkStateChange`` holding
    only the edges whose scale actually moved (``realization_deltas``),
    and each churn event becomes an ``AgentLeave`` of that agent handle.
    The stream is sorted by ``event_sort_key`` — replaying it through
    ``DesignService`` visits network states in realization order.
    """
    scen = sto.sample(key)
    events: list[Event] = []
    for t, changed in realization_deltas(scen):
        events.append(LinkStateChange(time=t, scales=changed))
    for c in scen.churn:
        events.append(AgentLeave(time=float(c.time), agent=int(c.agent)))
    return tuple(sorted(events, key=event_sort_key))
