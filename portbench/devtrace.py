"""Reduction of a ``torch.profiler`` trace (CUPTI) to the intervals the
per-layer metrics read: every operation that ran on the device, the union
of their intervals (busy time), and a breakdown of where the device's time
and its idle gaps went."""

from __future__ import annotations

import dataclasses

from torch.autograd import DeviceType

TOP = 10         # entries of each breakdown list
NAME_CHARS = 160
STEP_SPAN = "portbench.step"   # the benchmark's span around a step


@dataclasses.dataclass
class Trace:
    device_ops: list      # [(name, start s, duration s)], in start order
    host_ops: list        # [(name, start s, duration s)] on the host
    busy_s: float         # the union of the device ops' intervals
    wall_s: float         # the traced steps' wall time on the host clock

    def durations(self, fragment: str) -> list[float]:
        """Durations of the device ops whose name holds ``fragment``."""
        return [d for name, _, d in self.device_ops if fragment in name]


def _ns(event, what: str) -> int:
    get = getattr(event, f"{what}_ns", None)
    return get() if get is not None else getattr(event, f"{what}_us")() * 1000


def reduce(prof, wall_s: float) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name() == STEP_SPAN:       # the span's shadow on the device
            continue
        row = (e.name(), _ns(e, "start") * 1e-9, _ns(e, "duration") * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            device.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    device.sort(key=lambda r: r[1])
    return Trace(device, host, sum(b - a for a, b in _merged(device)), wall_s)


def _merged(ops: list) -> list[tuple[float, float]]:
    """The union of the ops' intervals as disjoint ``(start, end)``."""
    out: list[list[float]] = []
    for _, start, dur in ops:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], start + dur)
        else:
            out.append([start, start + dur])
    return [(a, b) for a, b in out]


def breakdown(trace: Trace) -> dict:
    """``{"device_ops": [[name, s]…], "idle_gaps": [[name, s]…]}``: the
    device operations that took most time, summed by name, and the longest
    gaps between device work, each named by the innermost host operation
    running at its middle."""
    by_name: dict[str, float] = {}
    for name, _, dur in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = _merged(trace.device_ops)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                   for a, b in zip(spans, spans[1:])), reverse=True)[:TOP]
    idle = []
    for length, mid in gaps:
        covering = [(start, name) for name, start, dur in trace.host_ops
                    if start <= mid <= start + dur]
        idle.append([max(covering)[1][:NAME_CHARS] if covering else "host",
                     length])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": idle}
