"""Planted trace-lint targets: a float32 op, an uncounted ``.item()``, a
target over its op budget, one over its read budget, one whose case
raises, and one with no budget."""

import torch

from repro_torch.analysis.tracelint import TraceCase, TraceTarget
from repro_torch.net import torch_engine


def _narrow(device):
    def run(x):
        return x.to(torch.float32) * 2

    return run, (torch.ones(4, dtype=torch.float64, device=device),)


def _uncounted(device):
    def run(x):
        return (x * 2).sum().item()

    return run, (torch.ones(4, dtype=torch.float64, device=device),)


def _many_ops(device):
    def run(x):
        for _ in range(10):
            x = x + 1
        return x

    return run, (torch.ones(4, dtype=torch.float64, device=device),)


def _counted_read(device):
    def run(x):
        return torch_engine._read_any(x > 0)

    return run, (torch.ones(4, dtype=torch.float64, device=device),)


def _broken(device):
    raise RuntimeError("planted: the case cannot be built")


def _target(name, make):
    return TraceTarget(name=name, path=f"planted/{name}.py", scope=name,
                       cases=(TraceCase(f"{name}-case", make),))


TARGETS = (
    _target("narrow", _narrow),            # planted: narrow-float-in-trace
    _target("uncounted", _uncounted),      # planted: uncounted-host-sync
    _target("many-ops", _many_ops),        # planted: op-budget-exceeded
    _target("counted-read", _counted_read),  # planted: sync-budget-exceeded
    _target("broken", _broken),            # planted: trace-error
    _target("unbudgeted", _many_ops),      # planted: missing-budget
)
