"""Straggler mitigation for decentralized training.

Lemma III.1 says equal bandwidth sharing is makespan-optimal when all
agents move the same κ — but a straggling *link or agent* breaks the
premise. Two mitigations, both of which keep D-PSGD's convergence
guarantees:

  * ``renormalized_mixing``: skip the straggler's exchange this round and
    renormalize W's rows over delivered neighbors (the effective W is
    still symmetric row-stochastic on the delivered support — a valid
    time-varying mixing matrix under [32]).
  * ``deadline_from_history``: per-round deadline = q-quantile of past
    round times × slack, the standard bounded-staleness trigger.

``StragglerSimulator`` models per-agent slowdowns on top of the fluid
network simulator to quantify the benefit in benchmarks.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def renormalized_mixing(
    w: np.ndarray, delivered: np.ndarray
) -> np.ndarray:
    """Zero out undelivered exchanges and restore row sums to 1.

    delivered: boolean [m, m]; delivered[i, j] ⇔ agent i received j's
    parameters this round (must be symmetric to keep W symmetric).
    """
    m = w.shape[0]
    delivered = np.asarray(delivered, bool)
    if not np.array_equal(delivered, delivered.T):
        raise ValueError("delivered matrix must be symmetric")
    w_eff = np.where(delivered, w, 0.0)
    np.fill_diagonal(w_eff, 0.0)
    # Push the missing mass back to the diagonal: W_ii = 1 − Σ_j W_ij.
    np.fill_diagonal(w_eff, 1.0 - w_eff.sum(axis=1))
    return w_eff


def deadline_from_history(
    history_s: list[float], quantile: float = 0.75, slack: float = 1.5,
    floor_s: float = 0.0,
) -> float:
    if not history_s:
        return float("inf")
    return max(float(np.quantile(history_s, quantile)) * slack, floor_s)


@dataclasses.dataclass
class StragglerSimulator:
    """Per-round agent slowdown model: normal rounds ~1×, straggle rounds
    ~``severity``× with probability ``prob`` per agent per round."""

    num_agents: int
    prob: float = 0.05
    severity: float = 4.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def round_slowdowns(self) -> np.ndarray:
        s = np.ones(self.num_agents)
        mask = self._rng.random(self.num_agents) < self.prob
        s[mask] = self.severity
        return s

    def scenario_events(
        self, horizon: float, round_time: float
    ) -> tuple:
        """Sample per-round slowdowns as fluid-simulator events.

        Each simulated gossip round [r·round_time, (r+1)·round_time)
        contributes one ``StragglerEvent`` per straggling agent, so the
        same stochastic model that drives ``round_time`` can degrade the
        network simulator (``repro_torch.net.simulate(scenario=...)``).
        """
        from repro_torch.net.simulator import StragglerEvent

        if round_time <= 0:
            raise ValueError("round_time must be positive")
        if not np.isfinite(horizon):
            raise ValueError("horizon must be finite")
        events = []
        r = 0
        while r * round_time < horizon:
            start = r * round_time
            stop = min(start + round_time, horizon)
            for agent in np.flatnonzero(self.round_slowdowns() > 1.0):
                events.append(
                    StragglerEvent(
                        agent=int(agent), slowdown=self.severity,
                        start=start, stop=stop,
                    )
                )
            r += 1
        return tuple(events)

    def round_time(
        self, base_time: float, w: np.ndarray, deadline: float | None = None
    ) -> tuple[float, np.ndarray]:
        """(elapsed, delivered) for one gossip round.

        An exchange (i, j) lands at base_time × max(slow_i, slow_j); with
        a deadline, late exchanges are dropped (delivered=False) and the
        round closes at the deadline.
        """
        slow = self.round_slowdowns()
        m = self.num_agents
        delivered = np.ones((m, m), bool)
        t_round = 0.0
        for i in range(m):
            for j in range(i + 1, m):
                if abs(w[i, j]) < 1e-12:
                    continue
                t = base_time * max(slow[i], slow[j])
                if deadline is not None and t > deadline:
                    delivered[i, j] = delivered[j, i] = False
                else:
                    t_round = max(t_round, t)
        if deadline is not None:
            t_round = min(max(t_round, base_time), deadline)
        return t_round, delivered
