"""Trace-lint target registry — every pricing entry point of the port.

``repro_torch.analysis.tracelint`` runs each ``TraceTarget`` registered in
``TARGETS`` on a small concrete instance under its recording dispatch
mode and certifies the dispatch-level contracts (float64 everywhere,
every device→host read counted by ``torch_engine.sync_count()``, op and
read budgets — see ``tracelint_manifest.txt``). All three pricing entries
funnel into the engine's one device entry ``net.torch_engine._run_batch``;
each target builds the arguments its *host path* builds, with the same
code the entry runs, so the certified dispatch is the one production
makes. The names and cases are the JAX package's
(``src/repro/analysis/tracelint_targets.py``):

``rollout-batch``    ``simulate_rollout_batch`` — a Monte-Carlo
                     ``RealizationBatch`` over Markov-modulated links
                     (two rollout widths, so the budget covers the batch
                     axis);
``phased-scan``      the phased lowering ``simulate_torch`` /
                     ``simulate_phased`` drive through ``_run_batch`` into
                     ``_simulate_batch`` — a deterministic multi-phase
                     capacity grid with extra boundaries;
``stochastic-price`` ``StochasticTau.price(engine="torch")`` — churned
                     realizations through the designer's
                     ``DeviceIncidence`` cache helper.

Keep cases tiny (a 2-agent line): what the contract needs is every op the
path dispatches, which a small instance dispatches as a large one does.
Each case's ``make(device)`` puts its tensors on ``device``: the CPU in
the lint and the tests, the card in ``chip_smoke.py``.
"""

from __future__ import annotations

import types

import numpy as np

from repro_torch.analysis.tracelint import TraceCase, TraceTarget

_CACHE: dict = {}


def _line_instance():
    """2-agent line instance: routed solution, overlay, incidence,
    device incidence — built once, shared by every case."""
    got = _CACHE.get("line")
    if got is None:
        from repro_torch.net import (
            build_overlay,
            compute_categories,
            demands_from_links,
            line_underlay,
            route_direct,
        )
        from repro_torch.net.simulator import compile_incidence
        from repro_torch.net.torch_engine import device_incidence

        kappa = 1e6
        u = line_underlay(2, capacity=125_000.0)
        ov = build_overlay(u, [0, 1])
        cats = compute_categories(ov)
        demands = demands_from_links([(0, 1)], kappa, 2)
        sol = route_direct(demands, cats, kappa)
        inc = compile_incidence(sol, ov)
        dev = device_incidence(
            inc, np.array([d.size for d in sol.demands], dtype=np.float64)
        )
        got = _CACHE["line"] = (sol, ov, inc, dev)
    return got


def _stochastic(ov, churn: bool):
    from repro_torch.net import MarkovLinkModel, StochasticScenario

    tau = 8.0  # ~kappa/capacity on the line instance
    edges = tuple(ov.underlay.graph.edges)[:4] or ((0, 1),)
    return StochasticScenario(
        links=(MarkovLinkModel(
            edges=edges, scales=(1.0, 0.1),
            transition=((0.5, 0.5), (0.25, 0.75)),
        ),),
        step=0.4 * tau, horizon=4 * tau,
        churn_agents=(0,) if churn else (),
        churn_hazard=0.15 if churn else 0.0,
    )


def _make_rollout_case(rollouts: int):
    """``simulate_rollout_batch`` over a seeded ``rollouts``-wide batch
    on the line instance."""

    def make(device):
        from repro_torch.net import torch_engine

        sol, ov, inc, _ = _line_instance()
        batch = _stochastic(ov, churn=False).realization_batch(
            0, rollouts, inc)

        def price(batch):
            return torch_engine.simulate_rollout_batch(
                sol, ov, batch, incidence=inc, device=device)

        return price, (batch,)

    return make


def _make_phased_case():
    """The phased lowering: a deterministic scenario with capacity phases
    plus caller boundaries — ``simulate_torch``'s ``densify_realizations``
    path (P > 1, R = 1) into ``_run_batch``."""

    def make(device):
        from repro_torch.net import CapacityPhase, Scenario, torch_engine
        from repro_torch.net.stochastic import densify_realizations

        sol, ov, inc, dev = _line_instance()
        edge = tuple(ov.underlay.graph.edges)[0]
        scenario = Scenario(capacity_phases=(
            CapacityPhase(start=2.0, scale={edge: 0.5}),
            CapacityPhase(start=5.0, scale=0.8),
        ))
        batch = densify_realizations(
            (scenario,), inc, extra_boundaries=(1.0, 3.0)
        )
        flow_source = np.array(
            [d.source for d in sol.demands], dtype=np.int64
        )
        cancel = torch_engine.batch_cancel_times(inc, flow_source, batch)
        args = torch_engine.device_args(
            dev, batch.starts, batch.capacity, cancel, max_events=10_000
        )
        return torch_engine._run_batch, (*args, device)

    return make


def _make_price_case():
    """``StochasticTau.price``'s torch path: the designer's
    ``DeviceIncidence`` cache helper + churned realizations."""

    def make(device):
        from repro_torch.core.priced_training import StochasticTau

        sol, ov, _, _ = _line_instance()
        outcome = types.SimpleNamespace(
            routing=sol, name="line2",
            design=types.SimpleNamespace(activated_links=((0, 1),)),
        )

        def price(cache):
            return StochasticTau.price(
                outcome, ov, _stochastic(ov, churn=True), rollouts=4,
                seed=0, engine="torch", routing_cache=cache, device=device,
            )

        return price, ({},)

    return make


TARGETS: tuple[TraceTarget, ...] = (
    TraceTarget(
        name="rollout-batch",
        path="src/repro_torch/net/torch_engine.py",
        scope="simulate_rollout_batch",
        cases=(
            TraceCase("line2-r4", _make_rollout_case(4)),
            TraceCase("line2-r8", _make_rollout_case(8)),
        ),
    ),
    TraceTarget(
        name="phased-scan",
        path="src/repro_torch/net/torch_engine.py",
        scope="_simulate_batch",
        cases=(TraceCase("line2-phased", _make_phased_case()),),
    ),
    TraceTarget(
        name="stochastic-price",
        path="src/repro_torch/core/priced_training.py",
        scope="StochasticTau.price",
        cases=(TraceCase("line2-churn-r4", _make_price_case()),),
    ),
)
