"""Network-priced DFL training — the loop the paper's Fig. 5 draws.

Counterpart of the JAX package's ``core/priced_training.py``.
``train_priced`` drives the D-PSGD step (``dpsgd.make_dpsgd_step``) with
the designer's mixing matrix while charging every gossip round its
network time, so loss-vs-wall-clock curves come out of the designed
overlay. This slice holds the static pricer:

  * ``StaticTau`` — every round costs the design's routed τ: the paper's
    static-network assumption.

The phased and stochastic pricers (``PhasedTau``, ``StochasticTau``,
``pricer_for``) price through the network simulator and arrive with it;
any object with ``kind`` and ``tau_for(round_index, t_start)`` is
accepted as a pricer meanwhile.

The communication strategy is pluggable (``GossipStrategy``): one-shot
mixing applies W once per model update; multi-round graph gossip applies
W r times — effective matrix Wʳ, r network rounds charged per update.

Every charged round lands in a replayable ``PricedTrainLog`` (same JSON
schema as the JAX package's: a log written by either loads in the other;
``validate()`` asserts the charged wall-clock is bitwise the running sum
of per-round τ), and ``train_priced`` accepts mid-run redesigns — the
fault-tolerance path swaps (W, pricer) on a named round and the log
shows the τ source switch.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.dpsgd import consensus_distance, mixing_plan
from repro_torch.core.gossip import effective_mixing_matrix
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GossipStrategy:
    """How one model update's communication is realized atop W.

    ``rounds=1`` is one-shot mixing (plain D-PSGD). ``rounds=r`` is
    multi-round graph gossip: r back-to-back exchanges per update, so
    the update mixes with Wʳ — ρ contracts r× faster per update — while
    the pricer charges r network rounds, each at its own τ. The strategy
    only changes *how often* the priced exchange runs, never its price.
    """

    rounds: int = 1
    label: str = ""

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"gossip rounds must be >= 1: {self.rounds}")

    @property
    def name(self) -> str:
        if self.label:
            return self.label
        return "one-shot" if self.rounds == 1 else f"gossip-x{self.rounds}"

    def effective_matrix(self, w: np.ndarray) -> np.ndarray:
        return effective_mixing_matrix(w, self.rounds)


@dataclasses.dataclass(frozen=True)
class StaticTau:
    """Constant per-round price — the design's routed τ."""

    tau: float
    label: str = "static"

    @property
    def kind(self) -> str:
        return "static"

    def tau_for(self, round_index: int, t_start: float) -> float:
        return float(self.tau)

    @classmethod
    def from_outcome(cls, outcome, label: str = "") -> "StaticTau":
        return cls(outcome.tau, label=label or outcome.name)


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One training step's charge: which design's τ, how much, when."""

    step: int
    design: str          # label of the design whose τ was charged
    pricing: str         # pricer kind ("static" | "phased" | ...)
    gossip_rounds: int   # network rounds this step (strategy.rounds)
    tau: float           # network seconds charged for this step
    wall_clock: float    # cumulative modeled wall-clock AFTER this step
    loss: float
    consensus: float = float("nan")  # logged every log_every steps


@dataclasses.dataclass
class PricedTrainLog:
    """Replayable per-round τ accounting of one priced training run.

    ``records`` has one entry per training step. The charged wall-clock
    is the exact running float sum of per-step τ (``validate()`` holds
    it bitwise), so a log replays to the same loss-vs-wall-clock curve
    it was recorded from — ``to_json``/``from_json`` round-trip every
    field through ``repr`` floats (exact for binary64).
    """

    records: list[RoundRecord] = dataclasses.field(default_factory=list)

    @property
    def steps(self) -> list[int]:
        return [r.step for r in self.records]

    @property
    def losses(self) -> list[float]:
        return [r.loss for r in self.records]

    @property
    def wall_clock(self) -> list[float]:
        return [r.wall_clock for r in self.records]

    @property
    def total_wall(self) -> float:
        return self.records[-1].wall_clock if self.records else 0.0

    def validate(self) -> None:
        """Charged wall-clock ≡ running sum of per-step τ, bitwise."""
        wall = 0.0
        for r in self.records:
            wall += r.tau
            if r.wall_clock != wall and not (
                np.isnan(r.wall_clock) and np.isnan(wall)
            ):
                raise ValueError(
                    f"step {r.step}: wall_clock {r.wall_clock!r} != "
                    f"running τ sum {wall!r}"
                )

    def time_to_loss(self, target: float) -> float:
        """Modeled wall-clock at which the loss first reaches
        ``target`` (inf if it never does) — the Fig. 5 x-axis read."""
        for r in self.records:
            if r.loss <= target:
                return r.wall_clock
        return float("inf")

    def to_json(self) -> str:
        return json.dumps(
            {"records": [dataclasses.asdict(r) for r in self.records]}
        )

    @classmethod
    def from_json(cls, text: str) -> "PricedTrainLog":
        data = json.loads(text)
        return cls(
            records=[RoundRecord(**r) for r in data["records"]]
        )


def train_priced(
    params: Any,
    step_fn: Callable,
    batcher: Callable[[int], Any],
    w: np.ndarray,
    pricer,
    num_steps: int,
    strategy: GossipStrategy = GossipStrategy(),
    design_label: str = "design",
    redesigns: Mapping[int, tuple[str, np.ndarray, Any]] | None = None,
    intervene: Callable[[int, Any], tuple[Any, tuple | None]] | None = None,
    log_every: int = 10,
    extract_params: Callable[[Any], Any] | None = None,
    compute_time_per_step: float = 0.0,
    device: str | torch.device | None = None,
) -> tuple[Any, PricedTrainLog]:
    """D-PSGD training charged per gossip round by a network pricer.

    Per training step: (1) apply any scheduled redesign or intervention,
    (2) run ``step_fn(carry, batch, plan, k)`` where ``plan`` is the
    ``dpsgd.MixingPlan`` of the strategy's effective matrix (Wʳ for
    multi-round gossip), (3) charge ``strategy.rounds`` network rounds,
    each priced by ``pricer.tau_for(global_round_index,
    wall_clock_at_round_start)``, plus ``compute_time_per_step`` (0 by
    default: D-PSGD overlaps compute with the exchange, eq. (2), and the
    paper's axis is communication-bound).

    The plan (dense W and the kernel's neighbour table) is built on the
    host once per design or redesign, never per step; a step makes no
    host synchronisation other than reading the loss (and the consensus
    distance on the steps that log it).

    ``redesigns`` maps step index → ``(label, new_w, new_pricer)``: at
    the *start* of that step the mixing matrix and pricer swap, so the
    step's rounds charge the new design's τ. ``intervene(k, carry)`` is
    the dynamic variant for fault-tolerance flows — it may shrink the
    carry (agent failure) and return a redesign tuple, or
    ``(carry, None)``.

    ``extract_params`` maps the step carry to the stacked params tree
    for consensus logging (identity by default). ``device=None`` means
    CUDA; the carry is moved there if it lives elsewhere.
    """
    if num_steps < 0:
        raise ValueError(f"num_steps must be nonnegative: {num_steps}")
    dev = compat.resolve_device(device)
    params = tree_map(lambda p: p.to(dev), params)
    redesigns = dict(redesigns or {})
    extract = extract_params or (lambda c: c)
    plan = mixing_plan(strategy.effective_matrix(w), dev)
    log = PricedTrainLog()
    wall = 0.0
    gossip_round = 0
    for k in range(num_steps):
        switch = redesigns.pop(k, None)
        if intervene is not None:
            params, dyn_switch = intervene(k, params)
            if dyn_switch is not None:
                switch = dyn_switch
        if switch is not None:
            design_label, new_w, pricer = switch
            plan = mixing_plan(strategy.effective_matrix(new_w), dev)
        batch = batcher(k)
        params, loss = step_fn(params, batch, plan, k)
        tau_step = 0.0
        for _ in range(strategy.rounds):
            tau_step += float(
                pricer.tau_for(gossip_round, wall + tau_step)
            )
            gossip_round += 1
        tau_step += compute_time_per_step
        wall += tau_step
        consensus = (
            float(consensus_distance(extract(params)))
            if log_every and (k % log_every == 0 or k == num_steps - 1)
            else float("nan")
        )
        log.records.append(
            RoundRecord(
                step=k,
                design=design_label,
                pricing=pricer.kind,
                gossip_rounds=strategy.rounds,
                tau=tau_step,
                wall_clock=wall,
                loss=float(loss),
                consensus=consensus,
            )
        )
    return params, log
