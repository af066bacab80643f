"""Elastic membership demo on the PyTorch port's design-as-a-service loop:
training continues while a replayed event stream degrades links, drops
agents, and adds one — and one redesign happens during a *pricing outage*
(injected fault), exercising the incumbent-keep degradation tier instead
of crashing the run. The counterpart of ``examples/elastic_failover.py``,
with its printed lines plus ``--device`` (the card by default, ``cpu``
for the CPU): the service's weight optimizations run there, and every
D-PSGD step updates the stacked parameters through the
``mixing_sgd_combine`` kernel (5 events × 40 steps, one launch a step).

    PYTHONPATH=src python examples/elastic_failover_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch import compat
from repro_torch.core import make_dpsgd_step, mixing
from repro_torch.core.dpsgd import mixing_plan
from repro_torch.net import build_overlay, lowest_degree_nodes, roofnet_like
from repro_torch.runtime.design_service import DesignService, ServiceConfig
from repro_torch.runtime.events import AgentJoin, AgentLeave, LinkStateChange
from repro_torch.runtime.fault_tolerance import grow_state, shrink_state
from repro_torch.runtime.faultinject import FaultInjector, FaultPlan


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the service and training run (default: "
                         "the card)")
    args = ap.parse_args()
    dev = compat.resolve_device(args.device)

    m = 8
    u = roofnet_like(seed=0)
    ov = build_overlay(u, lowest_degree_nodes(u, m))
    svc = DesignService(
        ov, kappa=1e6, config=ServiceConfig(design_iterations=12),
        device=dev,
    )
    print(f"start: m={svc.num_agents} rho={mixing.rho(svc.design):.3f} "
          f"tau={svc.tau:.3g}s")

    # The replayed stream: capacities sag, two agents depart (the first
    # while the pricing service is down), one joins, the links recover.
    worst = sorted(svc._binc.edges)[:3]
    free_node = next(
        n for n in sorted(u.graph.nodes) if n not in set(ov.agents)
    )
    events = [
        LinkStateChange(time=1.0, scales={e: 0.3 for e in worst}),
        AgentLeave(time=2.0, agent=1),   # pricing outage active here
        AgentLeave(time=3.0, agent=5),
        AgentJoin(time=4.0, node=free_node),
        LinkStateChange(time=5.0, scales={e: 1.0 for e in worst}),
    ]
    outage_at = 2.0  # every pricing attempt raises while processing this

    # toy objective: agents pull their value to per-agent targets
    targets = torch.arange(16, dtype=torch.float32, device=dev)[:, None]
    step_fn = make_dpsgd_step(
        lambda p, b: torch.mean((p["x"] - b) ** 2), learning_rate=0.05)
    params = {"x": torch.zeros((m, 1), dtype=torch.float32, device=dev)}

    k = 0
    for ev in events:
        plan = mixing_plan(svc.design, dev)
        for _ in range(40):  # train between events
            cur_m = params["x"].shape[0]
            params, _ = step_fn(params, targets[:cur_m], plan, k)
            k += 1
        if ev.time == outage_at:
            svc.injector = FaultInjector(
                FaultPlan(seed=0, rate=1.0, modes=("raise",)),
                clock=svc.clock,
            )
        members_before = svc.members
        rec = svc.process(ev)
        svc.injector = None
        # re-map the stacked state to the new membership
        if isinstance(ev, AgentLeave) and svc.members != members_before:
            keep = tuple(
                p for p, h in enumerate(members_before)
                if h in set(svc.members)
            )
            params = shrink_state(params, keep, len(members_before))
        elif isinstance(ev, AgentJoin) and svc.members != members_before:
            params = grow_state(params, svc.num_agents)
        print(
            f"[step {k}] {rec.event}: {rec.decision} ({rec.tier}) "
            f"m={svc.num_agents} rho={mixing.rho(svc.design):.3f} "
            f"tau={svc.tau:.3g}s"
            + (f" retries={rec.retries} faults={len(rec.faults)}"
               if rec.faults else "")
            + f" -- {rec.detail}"
        )

    print(f"final values: {params['x'].cpu().numpy().ravel().round(2)}")
    print(f"decision trail: {svc.log.decisions}")
    print(f"tiers hit: {svc.log.tiers}")


if __name__ == "__main__":
    main()
