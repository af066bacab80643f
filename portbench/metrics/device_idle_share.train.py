"""Device: the share of a step in which nothing ran on the card, in %: one
less the union of every device operation's interval in the profiled steps
over the wall time of as many unprofiled steps of the same run (the
window's mean step). The profiler slows the host, so the profiled steps'
own wall time would overstate the idle share."""


def read(reading: dict) -> float | None:
    trace, steps = reading["trace"], len(reading["step_s"])
    if trace is None or not trace.device_ops or not steps:
        return None
    unprofiled = reading["window_s"] / steps * reading["profiled_steps"]
    return 100.0 * (1.0 - trace.busy_s / unprofiled)
