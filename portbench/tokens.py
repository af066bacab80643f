"""Synthetic non-IID token streams: a frozen copy of the port's generator.

The traffic of a training cell is drawn here, not by the program, so that
a change to the program cannot change what it is measured on. Each agent's
tokens follow its own Dirichlet(alpha) mixture over ``num_topics`` shared
unigram distributions (the data heterogeneity that makes decentralized
mixing matter); every batch is deterministic in (seed, agent, step).
"""

from __future__ import annotations

import numpy as np


def _seed(seed: int) -> int:
    """Any whole number as a non-negative seed for numpy."""
    return int(seed) % 2**64


class TokenStream:
    """Topic-mixture token generator, one mixture per agent."""

    def __init__(self, vocab_size: int, num_agents: int, seed: int,
                 num_topics: int = 16, dirichlet_alpha: float = 0.3):
        self.vocab_size = vocab_size
        self.num_agents = num_agents
        self.seed = _seed(seed)
        root = np.random.default_rng(self.seed)
        self.topic_logits = root.standard_normal(
            (num_topics, vocab_size)).astype(np.float32)
        self.agent_mix = root.dirichlet(
            np.full(num_topics, dirichlet_alpha), size=num_agents
        ).astype(np.float32)
        self._dist = [self._distribution(a) for a in range(num_agents)]

    def _distribution(self, agent: int) -> np.ndarray:
        logits = self.agent_mix[agent] @ self.topic_logits
        e = np.exp(logits - logits.max())
        return e / e.sum()

    def batch(self, agent: int, step: int, rows: int,
              seq_len: int) -> np.ndarray:
        """``[rows, seq_len + 1]`` int32 tokens of ``agent`` at ``step``."""
        rng = np.random.default_rng((self.seed, agent, step, 0xD1F7))
        return rng.choice(self.vocab_size, size=(rows, seq_len + 1),
                          p=self._dist[agent]).astype(np.int32)

    def stacked(self, step: int, microbatches: int, rows: int,
                seq_len: int) -> np.ndarray:
        """``[agents, microbatches, rows, seq_len + 1]``: the launcher's
        batch layout, microbatch i of step t drawn at index t·k + i."""
        return np.stack([
            np.stack([self.batch(a, step * microbatches + i, rows, seq_len)
                      for i in range(microbatches)])
            for a in range(self.num_agents)
        ])
