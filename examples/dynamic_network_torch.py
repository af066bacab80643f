"""Price topology designs under degraded, time-varying edge networks, on
the PyTorch port.

The counterpart of ``examples/dynamic_network.py``, with its flags and
printed lines plus ``--device`` (where the weight optimizations run: the
card by default, ``cpu`` for the CPU).

The paper evaluates designs on a static network; real edge deployments
see diurnal capacity swings, background traffic, stragglers, and churn.
This example designs mixing topologies on the paper's Roofnet-like
scenario and re-prices each one under a configurable ``Scenario``:

    PYTHONPATH=src python examples/dynamic_network_torch.py \
        [--capacity-drop 0.5] [--local-drop 4] [--cross-flows 4] \
        [--stragglers 2] [--churn-agent 3] [--no-reroute] \
        [--stochastic] [--rollouts 5] [--device cpu]

Columns: τ_static is the closed-form per-iteration time on the healthy
network; τ_scen the fluid-simulated makespan of the *static-optimal*
schedule under the degraded network; τ_phased the makespan of the
*phase-adaptive* schedule (``route_time_expanded`` — one routing per
capacity phase, swapped mid-round with per-branch volume carryover).
The win column is τ_scen / τ_phased: how much of the degradation the
schedule claws back by re-routing around where the bottlenecks actually
moved. ``--local-drop N`` degrades only the middle underlay hops of N
overlay links' default paths (the hops a re-route can avoid) instead of
every edge uniformly — a uniform drop moves no bottleneck, so there is
nothing for phase-adaptive routing to exploit there.

``--stochastic`` replaces the single deterministic scenario with a
Markov-modulated capacity process on the same local-drop edges
(persistent good↔degraded chain, ``StochasticScenario``) and prices
each design as a *seeded expectation* over ``--rollouts`` realizations.
The schedule column becomes the *online* re-router — deciding at every
realized phase boundary from observed state only, with the
carryover-aware objective — and the table reports E[τ] for both
schedules plus the online p95 tail.
"""

import argparse

import numpy as np

from repro_torch.core import ConvergenceConstants, design
from repro_torch.net import (
    CapacityPhase,
    ChurnEvent,
    CrossTraffic,
    MarkovLinkModel,
    Scenario,
    StochasticScenario,
    StragglerEvent,
    build_overlay,
    compute_categories,
    lowest_degree_nodes,
    mid_path_edges,
    roofnet_like,
)
from repro_torch.runtime.fault_tolerance import failure_scenario


def build_scenario(args, overlay, tau_hint: float) -> Scenario:
    rng = np.random.default_rng(args.seed)
    phases = ()
    if args.capacity_drop < 1.0:
        if args.local_drop > 0:
            # Degrade the middle hops of a few neighboring-agent
            # overlay links' default paths — bottlenecks move, so
            # re-routing has somewhere to go (agent access edges are
            # spared; nothing avoids those). The sag persists for the
            # rest of the round: re-routing pays off when the phase it
            # adapts to actually lasts.
            m = overlay.num_agents
            drop = {
                e: args.capacity_drop
                for e in mid_path_edges(
                    overlay,
                    [(i, i + 1)
                     for i in range(min(args.local_drop, m - 1))],
                )
            }
            phases = (
                CapacityPhase(
                    start=tau_hint / 6,
                    scale=drop if drop else args.capacity_drop,
                ),
            )
        else:
            # Uniform sag a sixth of the way into the round, recovered
            # at two thirds — a bursty-interference profile. (Uniform
            # scaling moves no bottleneck, so phase-adaptive routing
            # has nothing to exploit here; use --local-drop for that.)
            phases = (
                CapacityPhase(start=tau_hint / 6,
                              scale=args.capacity_drop),
                CapacityPhase(start=2 * tau_hint / 3, scale=1.0),
            )
    nodes = list(overlay.underlay.graph.nodes)
    cross = tuple(
        CrossTraffic(
            src=int(rng.choice(nodes)),
            dst=int(rng.choice(nodes)),
            rate=args.cross_rate_mbps * 125_000.0,
        )
        for _ in range(args.cross_flows)
    )
    stragglers = tuple(
        StragglerEvent(
            agent=int(a), slowdown=args.straggler_slowdown,
            start=0.0, stop=tau_hint * 10,
        )
        for a in rng.choice(
            overlay.num_agents, size=args.stragglers, replace=False
        )
    )
    churn = ()
    if args.churn_agent >= 0:
        churn = failure_scenario(
            {args.churn_agent: tau_hint / 2}
        ).churn
    return Scenario(
        capacity_phases=phases, cross_traffic=cross,
        stragglers=stragglers, churn=churn,
    )


def build_stochastic(args, overlay, tau_hint: float) -> StochasticScenario:
    """Markov-modulated version of the local-drop degradation: the same
    mid-path hops, but sagging and recovering stochastically (persistent
    chain — mean sojourns of several boundaries), with the example's
    deterministic cross-traffic/stragglers/churn riding in ``base``."""
    m = overlay.num_agents
    edges = mid_path_edges(
        overlay,
        [(i, i + 1) for i in range(min(max(args.local_drop, 1), m - 1))],
    )
    base = build_scenario(
        argparse.Namespace(**{**vars(args), "capacity_drop": 1.0}),
        overlay, tau_hint,
    )
    return StochasticScenario(
        links=(MarkovLinkModel(
            edges=edges or ((0, 1),),
            scales=(1.0, args.capacity_drop if args.capacity_drop < 1.0
                    else 0.1),
            transition=((0.8, 0.2), (0.05, 0.95)),
        ),),
        step=0.5 * tau_hint,
        horizon=8 * tau_hint,
        base=base,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=10)
    ap.add_argument("--kappa-mb", type=float, default=94.47)
    ap.add_argument("--capacity-drop", type=float, default=0.1,
                    help="mid-round capacity multiplier (1.0 disables)")
    ap.add_argument("--local-drop", type=int, default=4,
                    help="degrade only the mid-path edges of this many "
                         "overlay links (0: degrade every edge)")
    ap.add_argument("--cross-flows", type=int, default=4)
    ap.add_argument("--cross-rate-mbps", type=float, default=0.3)
    ap.add_argument("--stragglers", type=int, default=2)
    ap.add_argument("--straggler-slowdown", type=float, default=4.0)
    ap.add_argument("--churn-agent", type=int, default=-1,
                    help="agent index that departs mid-round (-1: none)")
    ap.add_argument("--no-reroute", action="store_true",
                    help="skip the phase-adaptive schedule (static "
                         "pricing only, as in earlier revisions)")
    ap.add_argument("--stochastic", action="store_true",
                    help="Markov-modulate the local-drop edges and price "
                         "as a seeded expectation (online re-routing)")
    ap.add_argument("--rollouts", type=int, default=5,
                    help="realizations per design in --stochastic mode")
    ap.add_argument("--milp-time-limit", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the weight optimizations run (default: "
                         "the card)")
    args = ap.parse_args()
    reroute = not args.no_reroute

    u = roofnet_like(seed=args.seed)
    ov = build_overlay(u, lowest_degree_nodes(u, args.agents))
    cats = compute_categories(ov)
    kappa = args.kappa_mb * 1e6
    consts = ConvergenceConstants(epsilon=0.05)

    print(
        f"roofnet-like nodes={u.num_nodes} links={u.num_links} "
        f"agents={args.agents} drop={args.capacity_drop} "
        f"local={args.local_drop} cross={args.cross_flows} "
        f"stragglers={args.stragglers} churn={args.churn_agent} "
        f"reroute={reroute} stochastic={args.stochastic}"
        + (f" rollouts={args.rollouts}" if args.stochastic else "")
    )
    header = f"{'method':8s} {'tau_static':>11s} "
    scen_col = "E[tau_scen]" if args.stochastic else "tau_scen"
    header += f"{scen_col:>11s} "
    if reroute:
        on_col = "E[tau_onl]" if args.stochastic else "tau_phased"
        header += f"{on_col:>11s} {'win':>6s} "
        if args.stochastic:
            header += f"{'p95_onl':>9s} "
    header += f"{'total_h':>9s} {'total_scen_h':>13s}"
    print(header)
    for method in ("ring", "clique", "fmmd-wp"):
        static = design(
            method, cats, kappa, args.agents, overlay=ov,
            constants=consts, optimize_routing=reroute,
            milp_time_limit=args.milp_time_limit, device=args.device,
        )
        if args.stochastic:
            sto = build_stochastic(args, ov, static.tau or 1.0)
            degraded = design(
                method, cats, kappa, args.agents, overlay=ov,
                constants=consts, optimize_routing=reroute,
                stochastic=sto, stochastic_rollouts=args.rollouts,
                stochastic_seed=args.seed,
                reroute_per_phase=reroute,
                milp_time_limit=args.milp_time_limit, device=args.device,
            )
        else:
            scenario = build_scenario(args, ov, static.tau or 1.0)
            degraded = design(
                method, cats, kappa, args.agents, overlay=ov,
                constants=consts, optimize_routing=reroute,
                scenario=scenario, reroute_per_phase=reroute,
                milp_time_limit=args.milp_time_limit, device=args.device,
            )
        row = f"{method:8s} {static.tau:11.1f} "
        if reroute:
            win = (
                degraded.tau_static_sched / degraded.tau_phased
                if degraded.tau_phased else float("nan")
            )
            row += (
                f"{degraded.tau_static_sched:11.1f} "
                f"{degraded.tau_phased:11.1f} {win:5.2f}x "
            )
            if args.stochastic:
                row += f"{degraded.tau_p95:9.1f} "
        else:
            row += f"{degraded.tau:11.1f} "
        row += (
            f"{static.total_time/3600:9.1f} "
            f"{degraded.total_time/3600:13.1f}"
        )
        print(row)


if __name__ == "__main__":
    main()
