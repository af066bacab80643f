"""The paper's evaluation scenario (§IV-A) — the port's copy of the JAX
package's ``benchmarks/common.py``."""

from __future__ import annotations

import datetime
import json
import os

from repro_torch.core import ConvergenceConstants
from repro_torch.net import (
    PAPER_MODEL_BYTES,
    build_overlay,
    compute_categories,
    lowest_degree_nodes,
    roofnet_like,
)

NUM_AGENTS = 10
KAPPA = PAPER_MODEL_BYTES  # ResNet-50 fp32, 94.47 MB (paper §IV-A1)
CONSTANTS = ConvergenceConstants(epsilon=0.05)


def paper_scenario(seed: int = 0):
    """Roofnet-statistics-matched underlay, 10 lowest-degree agents."""
    u = roofnet_like(seed=seed)
    ov = build_overlay(u, lowest_degree_nodes(u, NUM_AGENTS))
    cats = compute_categories(ov)
    return u, ov, cats


def emit(name: str, us_per_call: float, derived: str) -> None:
    """Benchmark output contract: name,us_per_call,derived CSV.

    When ``$BENCH_JSON`` names a file, the record is also appended there
    as one JSON line (name/us_per_call/derived/timestamp).
    """
    print(f"{name},{us_per_call:.1f},{derived}")
    path = os.environ.get("BENCH_JSON")
    if path:
        record = {
            "name": name,
            "us_per_call": us_per_call,
            "derived": derived,
            "timestamp": datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat(),
        }
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
