"""Network-priced DFL training — the loop the paper's Fig. 5 draws.

Counterpart of the JAX package's ``core/priced_training.py``.
``train_priced`` drives the D-PSGD step (``dpsgd.make_dpsgd_step``) with
the designer's mixing matrix while charging every gossip round its
network time, so loss-vs-wall-clock curves come out of the designed
overlay. Three pricing models, one per simulation entry point of the
port's ``net/``:

  * ``StaticTau``    — every round costs the design's routed τ: the
    paper's static-network assumption.
  * ``PhasedTau``    — round k starts at the accumulated wall-clock t_k
    and costs ``simulate(sol, overlay, scenario.shifted(t_k))`` on the
    host (numpy engine "batched" by default), memoised by the shifted
    scenario's signature — rounds inside one phase re-price for free.
  * ``StochasticTau`` — per-round τ from a Monte-Carlo rollout batch
    (mean, p95, or per-round sample); with ``engine="torch"`` the whole
    batch prices as one pass of ``net/torch_engine.py`` on the device,
    against the ``DeviceIncidence`` cached per activated-link set.

``pricer_for`` picks one from a design outcome (``designer.DesignOutcome``,
or any object with ``.routing``, ``.design.activated_links``, ``.tau``,
``.tau_samples`` and ``.name``); any object with ``kind`` and
``tau_for(round_index, t_start)`` is accepted as a pricer.

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
from typing import Any, Callable, Mapping, MutableMapping

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.dpsgd import consensus_distance, mixing_plan
from repro_torch.core.gossip import effective_mixing_matrix
from repro_torch.net.simulator import (
    Scenario,
    SimResult,
    compile_incidence,
    simulate,
)
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


def _finite_tau(sim: SimResult) -> float:
    """Price one simulated round, mirroring ``evaluate_design``: a
    truncated run or one where churn cancelled every flow outright
    (all-NaN completions) prices as inf, never as cheap/free."""
    undelivered = sim.cancelled_branches > 0 and all(
        np.isnan(c) for c in sim.flow_completion
    )
    return float(
        np.inf if sim.unfinished_branches or undelivered else sim.makespan
    )


def _scenario_signature(sc: Scenario):
    """Hashable identity of a scenario's conditions (per-edge scale
    maps sorted), for memoizing per-round simulations."""

    def scale_key(s):
        if isinstance(s, Mapping):
            return tuple(sorted(s.items()))
        return s

    return (
        tuple((p.start, scale_key(p.scale)) for p in sc.capacity_phases),
        tuple(
            (c.src, c.dst, c.rate, c.start, c.stop)
            for c in sc.cross_traffic
        ),
        tuple(
            (s.agent, s.slowdown, s.start, s.stop) for s in sc.stragglers
        ),
        tuple((c.agent, c.time) for c in sc.churn),
        sc.floor_frac,
    )


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


class PhasedTau:
    """Deterministic time-varying price: round k costs the simulated
    makespan under ``scenario.shifted(t_k)`` where t_k is the round's
    wall-clock start — the same fluid model as
    ``evaluate_design(scenario=...)``, applied per round instead of
    once. The branch incidence compiles once; simulations memoize on
    the shifted scenario's signature, so every round inside one
    capacity phase after the last breakpoint reuses a single simulate.
    """

    def __init__(
        self,
        sol,
        overlay,
        scenario: Scenario,
        engine: str = "batched",
        label: str = "",
        device=None,
    ):
        if scenario is None:
            raise ValueError(
                "PhasedTau needs the deterministic scenario it prices; "
                "use StaticTau for a static network"
            )
        self.sol = sol
        self.overlay = overlay
        self.scenario = scenario
        self.engine = engine
        self.device = device
        self.label = label or "phased"
        self._incidence = (
            compile_incidence(sol, overlay) if sol.demands else None
        )
        self._memo: dict = {}

    @property
    def kind(self) -> str:
        return "phased"

    def tau_for(self, round_index: int, t_start: float) -> float:
        if self._incidence is None:
            return 0.0
        shifted = self.scenario.shifted(float(t_start))
        key = _scenario_signature(shifted)
        tau = self._memo.get(key)
        if tau is None:
            tau = _finite_tau(
                simulate(
                    self.sol, self.overlay,
                    scenario=None if shifted.is_trivial else shifted,
                    engine=self.engine, incidence=self._incidence,
                    device=self.device,
                )
            )
            self._memo[key] = tau
        return tau

    @classmethod
    def from_outcome(
        cls, outcome, overlay, scenario: Scenario,
        engine: str = "batched", label: str = "", device=None,
    ) -> "PhasedTau":
        return cls(
            outcome.routing, overlay, scenario, engine=engine,
            label=label or outcome.name, device=device,
        )


def _device_incidence_for(
    sol, overlay, activated_links, routing_cache: MutableMapping | None
):
    """The ``DeviceIncidence`` for a routed design, cached under the
    ``("torch-device-incidence", activated-link set)`` key — share a
    ``routing_cache`` and the incidence compiles exactly once per
    design."""
    from repro_torch.net import torch_engine

    dev_key = ("torch-device-incidence", frozenset(activated_links))
    dev = (
        routing_cache.get(dev_key)
        if routing_cache is not None else None
    )
    if dev is None:
        binc = compile_incidence(sol, overlay)
        flow_size = np.array(
            [d.size for d in sol.demands], dtype=np.float64
        )
        dev = torch_engine.device_incidence(binc, flow_size)
        if routing_cache is not None:
            routing_cache[dev_key] = dev
    return dev


@dataclasses.dataclass(frozen=True)
class StochasticTau:
    """Per-round price from a Monte-Carlo τ sample set.

    ``reduce="mean"``/``"p95"`` charge every round the expectation /
    tail of the rollout batch (risk-neutral vs conservative budgeting);
    ``reduce="sample"`` charges round k the k-th sample (cycling), so a
    training run experiences the *distribution* — per-round τ varies,
    replayable because the samples are seeded. Build via
    ``from_outcome`` (an outcome already priced with ``stochastic=``
    donates its ``tau_samples``) or ``price`` (one torch-engine rollout
    batch on the device, through the ``DeviceIncidence`` cache).
    """

    samples: tuple[float, ...]
    reduce: str = "mean"
    label: str = "stochastic"

    def __post_init__(self):
        if not self.samples:
            raise ValueError("StochasticTau needs at least one τ sample")
        if self.reduce not in ("mean", "p95", "sample"):
            raise ValueError(
                f"unknown reduce {self.reduce!r}: valid reductions are "
                "'mean', 'p95', and 'sample'"
            )

    @property
    def kind(self) -> str:
        return f"stochastic-{self.reduce}"

    @property
    def tau_mean(self) -> float:
        return float(np.mean(self.samples))

    @property
    def tau_p95(self) -> float:
        return float(np.percentile(self.samples, 95.0))

    def tau_for(self, round_index: int, t_start: float) -> float:
        if self.reduce == "mean":
            return self.tau_mean
        if self.reduce == "p95":
            return self.tau_p95
        return float(self.samples[round_index % len(self.samples)])

    @classmethod
    def from_outcome(
        cls, outcome, reduce: str = "mean", label: str = ""
    ) -> "StochasticTau":
        if not outcome.tau_samples:
            raise ValueError(
                "outcome carries no tau_samples; price it with "
                "stochastic= (evaluate_design) or use StochasticTau.price"
            )
        return cls(
            samples=outcome.tau_samples, reduce=reduce,
            label=label or outcome.name,
        )

    @classmethod
    def price(
        cls,
        outcome,
        overlay,
        stochastic,
        rollouts: int = 256,
        seed: int = 0,
        engine: str = "torch",
        reduce: str = "mean",
        routing_cache: MutableMapping | None = None,
        label: str = "",
        device=None,
    ) -> "StochasticTau":
        """Price the outcome's routed schedule over ``rollouts`` seeded
        realizations. ``engine="torch"`` runs them as one device pass
        (``device=None`` means CUDA) against a ``DeviceIncidence`` cached
        under the ``("torch-device-incidence", activated-link set)`` key
        — share a ``routing_cache`` and the incidence compiles exactly
        once per design. Any other engine is a numpy ``simulate`` engine,
        run once per realization on the host."""
        sol = outcome.routing
        if not sol.demands:
            return cls(samples=(0.0,), reduce=reduce, label=label)
        if engine == "torch":
            from repro_torch.net import torch_engine

            dev = _device_incidence_for(
                sol, overlay, outcome.design.activated_links,
                routing_cache,
            )
            batch = stochastic.realization_batch(seed, rollouts, dev.source)
            sims = torch_engine.rollout_batch_results(
                sol, dev, batch, device=device
            )
        else:
            sims = [
                simulate(
                    sol, overlay, scenario=realization, engine=engine
                )
                for realization in stochastic.sample_many(seed, rollouts)
            ]
        return cls(
            samples=tuple(_finite_tau(s) for s in sims),
            reduce=reduce,
            label=label or outcome.name,
        )


def pricer_for(
    outcome,
    mode: str = "static",
    overlay=None,
    scenario: Scenario | None = None,
    stochastic=None,
    rollouts: int = 256,
    seed: int = 0,
    engine: str = "batched",
    reduce: str = "mean",
    routing_cache: MutableMapping | None = None,
    device=None,
):
    """One pricer per pricing mode, from a ``DesignOutcome``.

    mode="static"      → ``StaticTau`` at ``outcome.tau`` (which is
                         already scenario- or expectation-priced when
                         the outcome was).
    mode="phased"      → ``PhasedTau`` over ``scenario`` (requires
                         ``overlay``; any numpy/torch simulate engine).
    mode="stochastic"  → ``StochasticTau``: reuses ``outcome.tau_samples``
                         when present and ``stochastic`` is None, else
                         prices a fresh rollout batch (``engine="torch"``
                         for the one-pass device path, on ``device``).

    ``outcome`` is duck-typed: ``.routing``, ``.design.activated_links``,
    ``.tau``, ``.tau_samples`` and ``.name`` are what is read.
    """
    if mode == "static":
        return StaticTau.from_outcome(outcome)
    if mode == "phased":
        if overlay is None or scenario is None:
            raise ValueError("phased pricing needs overlay= and scenario=")
        return PhasedTau.from_outcome(
            outcome, overlay, scenario, engine=engine, device=device
        )
    if mode == "stochastic":
        if stochastic is None:
            return StochasticTau.from_outcome(outcome, reduce=reduce)
        if overlay is None:
            raise ValueError("stochastic pricing needs overlay=")
        return StochasticTau.price(
            outcome, overlay, stochastic, rollouts=rollouts, seed=seed,
            engine=engine, reduce=reduce, routing_cache=routing_cache,
            device=device,
        )
    raise ValueError(
        f"unknown pricing mode {mode!r}: valid modes are 'static', "
        "'phased', and 'stochastic'"
    )


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
