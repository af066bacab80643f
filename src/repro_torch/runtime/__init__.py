"""Runtime: fault tolerance, design service, stragglers, compression —
the port's copies of the JAX package's ``repro.runtime`` modules."""

from repro_torch.runtime import (
    compression,
    design_service,
    events,
    fault_tolerance,
    faultinject,
    stragglers,
)
