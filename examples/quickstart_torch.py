"""Quickstart on the PyTorch port: design a communication-efficient mixing
matrix for DFL over a bandwidth-limited edge network, route its traffic,
and price the total training time — the paper's full pipeline in ~30
lines. The counterpart of ``examples/quickstart.py``, with its printed
lines; the weight optimizations run in float64 on ``--device`` (the card
by default, ``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.core import ConvergenceConstants, design
from repro_torch.net import (
    PAPER_MODEL_BYTES,
    build_overlay,
    compute_categories,
    lowest_degree_nodes,
    roofnet_like,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the weight optimizations run (default: "
                         "the card)")
    args = ap.parse_args()

    # 1. The edge network: Roofnet-like mesh, 10 lowest-degree agents.
    underlay = roofnet_like(seed=0)
    overlay = build_overlay(underlay, lowest_degree_nodes(underlay, 10))

    # 2. What the overlay can learn about the underlay (Def. 1 / [17]).
    categories = compute_categories(overlay)
    print(f"categories: {len(categories.families)}, "
          f"C_min = {categories.min_capacity()/1e3:.0f} KB/s")

    # 3. Joint design: FMMD-WP mixing matrix + optimal overlay routing.
    constants = ConvergenceConstants(epsilon=0.05)
    for method in ("clique", "ring", "fmmd-wp"):
        out = design(
            method, categories, PAPER_MODEL_BYTES, 10,
            overlay=overlay, iterations=12, constants=constants,
            device=args.device,
        )
        print(
            f"{method:8s}: links={len(out.design.activated_links):2d} "
            f"rho={out.rho:.3f} tau={out.tau:8.1f}s "
            f"K(rho)={out.iterations_to_eps:8.1f} "
            f"total={out.total_time/3600:8.1f}h [{out.routing.method}]"
        )


if __name__ == "__main__":
    main()
