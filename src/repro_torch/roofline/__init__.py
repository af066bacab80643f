"""Roofline analysis from the analytic cell models and the collectives
the port counts (counterpart of the JAX package's ``roofline/``)."""

from repro_torch.roofline.analysis import (
    H100,
    CollectiveStats,
    Peaks,
    RooflineReport,
    report,
)
