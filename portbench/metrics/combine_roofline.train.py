"""Gossip (``core/gossip.mix_sparse`` → the ``mixing_sgd_combine`` kernel,
its ``g=None`` stacked form): the launches' least time over their device
time, in %. A step launches the kernel once a parameter leaf, on x ``[A,
N]``; its least time is x read once and the output written once, at the
HBM peak. Read only where the profiled steps launched it once a leaf."""

import math

from portbench import peaks

KERNEL = "combine_kernel"


def bound_s(agents: int, numel: int, itemsize: int) -> float:
    """Least seconds of one launch on ``[agents, numel]``."""
    return 2 * agents * numel * itemsize / peaks.HBM_BYTES_PER_S


def read(reading: dict) -> float | None:
    trace = reading["trace"]
    if trace is None:
        return None
    times = trace.durations(KERNEL)
    shapes = reading["param_shapes"]
    steps = reading["profiled_steps"]
    if not times or len(times) != steps * len(shapes):
        return None
    itemsize = 2 if reading["model"]["param_dtype"] == "bfloat16" else 4
    least = steps * sum(bound_s(reading["agents"], math.prod(s), itemsize)
                        for s in shapes.values())
    return 100.0 * least / sum(times)
