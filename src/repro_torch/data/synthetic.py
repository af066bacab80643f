"""Synthetic token data with controllable non-IID agent partitions.

The paper distributes CIFAR-10 across 10 agents; for LM training we
generate deterministic synthetic token streams whose *unigram skew*
varies per agent (Dirichlet over topic mixtures), reproducing the data
heterogeneity (ζ̂ of assumption (3)) that makes decentralized mixing
matter. Everything is stateless-deterministic in (seed, agent, step) so
restarts resume identically with no data-loader checkpoints.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    num_agents: int = 1
    num_topics: int = 16
    dirichlet_alpha: float = 0.3   # smaller = more heterogeneous agents
    seed: int = 0


class SyntheticTokenStream:
    """Markov-ish topic-mixture token generator, one mixture per agent."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # Topic-conditional unigram distributions (shared across agents).
        self.topic_logits = root.standard_normal(
            (cfg.num_topics, cfg.vocab_size)
        ).astype(np.float32)
        # Per-agent topic mixtures (the non-IID knob).
        self.agent_mix = root.dirichlet(
            np.full(cfg.num_topics, cfg.dirichlet_alpha), size=cfg.num_agents
        ).astype(np.float32)

    def agent_distribution(self, agent: int) -> np.ndarray:
        logits = self.agent_mix[agent] @ self.topic_logits
        e = np.exp(logits - logits.max())
        return e / e.sum()

    def batch(
        self, agent: int, step: int, batch_size: int, seq_len: int | None = None
    ) -> np.ndarray:
        """[batch, seq_len+1] int32 tokens, deterministic in (agent, step)."""
        s = seq_len or self.cfg.seq_len
        rng = np.random.default_rng(
            (self.cfg.seed, agent, step, 0xD1F7)
        )
        p = self.agent_distribution(agent)
        return rng.choice(
            self.cfg.vocab_size, size=(batch_size, s + 1), p=p
        ).astype(np.int32)

    def stacked_batch(self, step: int, per_agent_batch: int,
                      seq_len: int | None = None) -> np.ndarray:
        """[num_agents, per_agent_batch, seq+1] for the stacked trainer."""
        return np.stack(
            [
                self.batch(a, step, per_agent_batch, seq_len)
                for a in range(self.cfg.num_agents)
            ]
        )

    def heterogeneity(self) -> float:
        """Mean TV-distance between agent unigram distributions — an
        observable proxy for ζ̂."""
        dists = [
            self.agent_distribution(a) for a in range(self.cfg.num_agents)
        ]
        mean = np.mean(dists, axis=0)
        return float(
            np.mean([0.5 * np.abs(d - mean).sum() for d in dists])
        )
