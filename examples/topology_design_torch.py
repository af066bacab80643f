"""Design-space exploration CLI on the PyTorch port: compare all design
methods on a chosen underlay and report the full Table-I-style summary.
The counterpart of ``examples/topology_design.py``, with its flags and
printed lines plus ``--device`` (where the weight optimizations run: the
card by default, ``cpu`` for the CPU).

    PYTHONPATH=src python examples/topology_design_torch.py \
        --underlay roofnet --agents 10 --kappa-mb 94.47 [--routing] \
        [--device cpu]
"""

import argparse

from repro_torch.core import ConvergenceConstants, design
from repro_torch.net import (
    build_overlay,
    compute_categories,
    grid_underlay,
    lowest_degree_nodes,
    random_geometric_underlay,
    roofnet_like,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--underlay", default="roofnet",
                    choices=["roofnet", "grid", "geometric"])
    ap.add_argument("--agents", type=int, default=10)
    ap.add_argument("--kappa-mb", type=float, default=94.47)
    ap.add_argument("--iterations", type=int, default=12)
    ap.add_argument("--routing", action="store_true",
                    help="solve optimal overlay routing (slower)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the weight optimizations run (default: "
                         "the card)")
    args = ap.parse_args()

    if args.underlay == "roofnet":
        u = roofnet_like(seed=args.seed)
    elif args.underlay == "grid":
        u = grid_underlay(6, 7)
    else:
        u = random_geometric_underlay(40, seed=args.seed)
    ov = build_overlay(u, lowest_degree_nodes(u, args.agents))
    cats = compute_categories(ov)
    kappa = args.kappa_mb * 1e6
    consts = ConvergenceConstants(epsilon=0.05)

    print(f"underlay={args.underlay} nodes={u.num_nodes} links={u.num_links} "
          f"agents={args.agents} categories={len(cats.families)}")
    print(f"{'method':8s} {'links':>5s} {'rho':>7s} {'tau_bar':>9s} "
          f"{'tau':>9s} {'K(rho)':>10s} {'total_h':>9s} {'design_s':>9s}")
    for method in ("clique", "ring", "prim", "sca", "fmmd-wp"):
        out = design(method, cats, kappa, args.agents, overlay=ov,
                     iterations=args.iterations, constants=consts,
                     optimize_routing=args.routing, device=args.device)
        print(
            f"{method:8s} {len(out.design.activated_links):5d} "
            f"{out.rho:7.4f} {out.tau_bar:9.1f} {out.tau:9.1f} "
            f"{out.iterations_to_eps:10.1f} {out.total_time/3600:9.1f} "
            f"{out.design.design_seconds:9.2f}"
        )


if __name__ == "__main__":
    main()
