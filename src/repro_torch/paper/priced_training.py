"""The paper's gate: ≥ 80 % modeled training-time reduction, FMMD-P vs Clique.

The port's copy of the JAX package's ``benchmarks/priced_training.py``.
On a Roofnet-like instance (10 lowest-degree agents, 94 MB model
payload), training over the FMMD-P designed overlay reaches the Clique
baseline's final loss in ≤ 20 % of the modeled wall-clock — every gossip
round charged its network τ through ``core.priced_training`` (the same
``evaluate_design`` pricing path the designer uses).

One command prints the loss-vs-wall-clock curves for all five schemes
(Clique / ring / prim / FMMD-P / SCA) and enforces the gate:

    python -m repro_torch.paper.priced_training               # on the GPU
    python -m repro_torch.paper.priced_training --device cpu  # on the CPU

Exit is nonzero if the reduction drops below GATE_REDUCTION or the final
losses diverge by more than LOSS_TOL (the reduction is only meaningful at
equal training quality).
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.paper.fig5_training import run
from repro_torch.paper.scenario import emit

GATE_REDUCTION = 0.80
LOSS_TOL = 0.02
STEPS = 120


def gate_numbers(res: dict) -> dict:
    """The gate's arithmetic on ``run()``'s results: the equal-quality
    target (the worse of the two final losses), each scheme's modeled
    time to reach it, the reduction and the final-loss gap."""
    base = res["clique"]
    fm = res["fmmd-wp"]
    loss_gap = abs(fm["final_loss"] - base["final_loss"])
    # Time for each scheme to reach the worse of the two final losses:
    # the equal-quality point the reduction is measured at.
    target = max(base["final_loss"], fm["final_loss"]) + 1e-9
    t_clique = min(base["log"].time_to_loss(target), base["time_to_final"])
    t_fmmd = min(fm["log"].time_to_loss(target), fm["time_to_final"])
    reduction = 1.0 - t_fmmd / max(t_clique, 1e-9)
    return {
        "target": target, "t_clique": t_clique, "t_fmmd": t_fmmd,
        "reduction": reduction, "loss_gap": loss_gap,
        "tau_model": fm["tau_model"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    res = run(steps=STEPS, device=args.device)
    dt = time.perf_counter() - t0

    # Loss-vs-wall-clock curves (the Fig. 5 x-axis), from the per-round
    # charged log — replayable, not steps × one constant.
    for name, v in res.items():
        print(f"  curve[{name}] tau_model={v['tau_model']}")
        for rec in v["log"].records[:: max(1, STEPS // 6)]:
            print(
                f"    step={rec.step:4d} wall={rec.wall_clock/3600:8.2f}h "
                f"loss={rec.loss:.4f}"
            )

    g = gate_numbers(res)
    emit(
        "priced_training",
        1e6 * dt,
        f"time_reduction_ratio={g['reduction']:.3f};"
        f"final_loss_gap={g['loss_gap']:.4f};"
        f"t_clique_h={g['t_clique']/3600:.1f};t_fmmd_h={g['t_fmmd']/3600:.1f};"
        f"tau_model={g['tau_model']}",
    )
    print(
        f"  FMMD-P reaches loss {g['target']:.4f} in {g['t_fmmd']/3600:.1f}h "
        f"vs Clique {g['t_clique']/3600:.1f}h -> "
        f"{100*g['reduction']:.0f}% reduction "
        f"(gate >= {100*GATE_REDUCTION:.0f}%, loss gap {g['loss_gap']:.4f} "
        f"<= {LOSS_TOL})"
    )
    if g["loss_gap"] > LOSS_TOL:
        print(f"  GATE FAIL: final losses diverge ({g['loss_gap']:.4f})")
        return 1
    if g["reduction"] < GATE_REDUCTION:
        print(f"  GATE FAIL: reduction {g['reduction']:.3f} < {GATE_REDUCTION}")
        return 1
    print("  GATE PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
