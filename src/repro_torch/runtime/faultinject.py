"""Seeded fault injection for the design service's pricing calls.

Robustness claims are only as good as the faults they were tested
against, so the service's chaos story is a *harness*, not ad-hoc
monkeypatching: a ``FaultInjector`` wraps every pricing/redesign attempt
and, on a schedule that is a pure function of ``(seed, call index)``,
makes the call

  * ``raise``   — fail outright (``PricingFault``), before any work;
  * ``timeout`` — burn ``timeout_seconds`` of *virtual* clock, then fail
    (``PricingTimeout``) — no wall-clock reads, per the determinism lint;
  * ``nan``     — run the real computation, then hand back a poisoned
    copy (the caller supplies the ``poison`` transform — e.g. stamping
    τ to NaN), modelling a numerically-corrupted result;
  * ``stale``   — skip the computation and replay the *previous*
    successful result, modelling a cache or replica serving an old
    answer. The service detects cross-epoch staleness via the epoch
    stamp on its candidates.

Determinism: the per-call draw is ``default_rng((seed, call_index))``,
so fault schedules are reproducible per call even if earlier calls are
added or removed — the property that keeps chaos tests debuggable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


class PricingFault(RuntimeError):
    """A pricing/redesign attempt failed (injected or organic)."""


class PricingTimeout(PricingFault):
    """A pricing attempt exceeded its (virtual) deadline."""


_MODES = ("raise", "timeout", "nan", "stale")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded schedule of injected pricing faults.

    ``rate`` is the per-call fault probability; ``modes`` the fault
    kinds drawn uniformly when a call faults. ``rate=0`` is the
    fault-free plan (every call passes through).
    """

    seed: int = 0
    rate: float = 0.0
    modes: Sequence[str] = _MODES
    timeout_seconds: float = 5.0

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate {self.rate} outside [0, 1]")
        bad = [m for m in self.modes if m not in _MODES]
        if bad or not self.modes:
            raise ValueError(
                f"unknown fault modes {bad}; choose from {_MODES}"
            )
        if self.timeout_seconds < 0:
            raise ValueError("timeout_seconds must be nonnegative")


class FaultInjector:
    """Wraps pricing calls, injecting faults per a ``FaultPlan``.

    ``clock`` is the service's virtual clock (``advance(seconds)``);
    timeouts advance it so retry/backoff arithmetic stays deterministic.
    ``injected`` records ``(call_index, mode)`` for every fault actually
    delivered — the ground truth chaos tests assert the ``ServiceLog``
    against.
    """

    def __init__(self, plan: FaultPlan, clock=None):
        self.plan = plan
        self._clock = clock
        self.calls = 0
        self.injected: list[tuple[int, str]] = []
        self._last_good = None
        self._has_last = False

    def _draw(self, idx: int) -> str | None:
        if self.plan.rate <= 0.0:
            return None
        rng = np.random.default_rng((self.plan.seed, idx))
        if rng.random() >= self.plan.rate:
            return None
        return self.plan.modes[int(rng.integers(len(self.plan.modes)))]

    def call(self, fn: Callable[[], object], poison=None):
        """Run ``fn`` under the fault schedule.

        ``poison`` transforms a clean result into a corrupted one for
        the ``nan`` mode; without it the mode degrades to ``raise``.
        """
        idx = self.calls
        self.calls += 1
        mode = self._draw(idx)
        if mode == "stale" and not self._has_last:
            mode = "raise"  # nothing cached yet: fail outright
        if mode == "nan" and poison is None:
            mode = "raise"
        if mode == "raise":
            self.injected.append((idx, "raise"))
            raise PricingFault(f"injected fault at pricing call {idx}")
        if mode == "timeout":
            self.injected.append((idx, "timeout"))
            if self._clock is not None:
                self._clock.advance(self.plan.timeout_seconds)
            raise PricingTimeout(
                f"injected timeout ({self.plan.timeout_seconds}s) at "
                f"pricing call {idx}"
            )
        if mode == "stale":
            self.injected.append((idx, "stale"))
            return self._last_good
        result = fn()
        self._last_good = result
        self._has_last = True
        if mode == "nan":
            self.injected.append((idx, "nan"))
            return poison(result)
        return result
