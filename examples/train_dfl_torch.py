"""End-to-end driver of the PyTorch port: decentralized training of a
~100M-parameter LM with D-PSGD, the designed mixing matrix, non-IID data,
checkpointing, and fault injection (one agent dies mid-run; the mixing
matrix is re-designed on the survivors, the charged τ switches to the new
design's, and training continues) — every gossip round charged its
*simulated* network time. The counterpart of ``examples/train_dfl.py``,
with the same flags, defaults and printed lines.

    PYTHONPATH=src python examples/train_dfl_torch.py [--steps 300]
        [--agents 8] [--pricing static|phased|stochastic]
        [--engine batched|torch] [--gossip-rounds 1] [--prox-mu 0.0]
        [--log-json out.json] [--device cpu]

Pricing models (see docs/priced-training.md):
  static     — every round costs the design's routed τ.
  phased     — a mid-run capacity sag (25% on the overlay's mid-path
               hops at --degrade-at wall-seconds); round k is priced
               under the phase active at its wall-clock start.
  stochastic — Markov-modulated mid-path hops; per-round τ cycles the
               seeded rollout samples (one pass on the card with
               --engine torch).

This runs the port's model substrate (an xlstm-125m-class config reduced
by --width-scale) through the simulation-mode D-PSGD trainer, every
update through the ``mixing_sgd_combine`` kernel on the card. On a
cluster, the same design feeds ``repro_torch.launch.train`` instead.
``--device`` defaults to the card; ``--device cpu`` runs the kernels'
plain versions.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    ConvergenceConstants,
    GossipStrategy,
    design,
    evaluate_design,
    make_dpsgd_step,
    mixing,
    pricer_for,
    replicate_for_agents,
    train_priced,
)
from repro_torch.core.fmmd import FMMDResult
from repro_torch.data import DataConfig, SyntheticTokenStream
from repro_torch.models import model as M
from repro_torch.net import (
    CapacityPhase,
    MarkovLinkModel,
    Scenario,
    StochasticScenario,
    activated_links_from_matrix,
    build_overlay,
    compute_categories,
    lowest_degree_nodes,
    mid_path_edges,
    roofnet_like,
)
from repro_torch.runtime.fault_tolerance import FaultToleranceController

CONSTANTS = ConvergenceConstants(epsilon=0.05)


def build_model(width_scale: float) -> ModelConfig:
    d = max(64, int(768 * width_scale))
    return ModelConfig(
        name="dfl-lm",
        family="dense",
        num_layers=4,
        d_model=d,
        num_heads=4,
        num_kv_heads=2,
        d_ff=4 * d,
        vocab_size=8192,
        block_pattern=("attn",),
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )


def outcome_from_matrix(w, cats, kappa, m, overlay, device):
    """Price an externally produced mixing matrix (the fault-tolerance
    redesign) through the same evaluate_design path as a fresh design."""
    d = FMMDResult(
        matrix=np.asarray(w, dtype=np.float64),
        activated_links=tuple(activated_links_from_matrix(w)),
        rho=mixing.rho(np.asarray(w, dtype=np.float64)),
        rho_trajectory=(),
        selected_atoms=(),
        design_seconds=0.0,
        variant="fmmd-wp-redesign",
    )
    return evaluate_design(d, cats, kappa, m, CONSTANTS, overlay=overlay,
                           device=device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--width-scale", type=float, default=0.25)
    ap.add_argument("--fail-agent-at", type=int, default=60)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--pricing", default="static",
                    choices=("static", "phased", "stochastic"))
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "torch"),
                    help="simulate engine for pricing (torch = one-pass "
                         "stochastic rollouts on the device)")
    ap.add_argument("--degrade-at", type=float, default=None,
                    help="phased pricing: wall-seconds at which mid-path "
                         "hops sag to 25%% (default: 3 rounds in)")
    ap.add_argument("--rollouts", type=int, default=32)
    ap.add_argument("--gossip-rounds", type=int, default=1,
                    help=">1 = multi-round graph gossip (W^r per update, "
                         "r priced rounds)")
    ap.add_argument("--prox-mu", type=float, default=0.0,
                    help="FedProx-style proximal coefficient (non-IID "
                         "drift damping)")
    ap.add_argument("--log-json", default=None,
                    help="write the replayable per-round τ log here")
    ap.add_argument("--device", default=None,
                    help="cpu for the kernels' plain versions (default: "
                         "the card)")
    args = ap.parse_args()

    dev = args.device
    m = args.agents
    cfg = build_model(args.width_scale)
    print(f"model: {M.parameter_count(cfg)/1e6:.1f}M params")

    underlay = roofnet_like(seed=0)
    overlay = build_overlay(underlay, lowest_degree_nodes(underlay, m))
    cats = compute_categories(overlay)
    kappa = M.parameter_count(cfg) * 4  # fp32 payload
    out = design("fmmd-wp", cats, kappa, m, overlay=overlay, iterations=12,
                 constants=CONSTANTS, device=dev)
    print(f"design: rho={out.rho:.3f} tau={out.tau:.1f}s "
          f"links={len(out.design.activated_links)}")

    # --- pricing model -----------------------------------------------------
    scenario = None
    sto = None
    if args.pricing == "phased":
        t_sag = (
            args.degrade_at if args.degrade_at is not None else 3 * out.tau
        )
        hops = mid_path_edges(overlay, out.design.activated_links)
        scenario = Scenario(capacity_phases=(
            CapacityPhase(start=t_sag,
                          scale={e: 0.25 for e in hops}),
        ))
        print(f"phased pricing: {len(hops)} mid-path hops sag to 25% "
              f"at t={t_sag:.0f}s")
    elif args.pricing == "stochastic":
        hops = mid_path_edges(overlay, out.design.activated_links)
        sto = StochasticScenario(
            links=(MarkovLinkModel(
                edges=tuple(hops), scales=(1.0, 0.2),
                transition=((0.8, 0.2), (0.3, 0.7)),
            ),),
            step=max(out.tau / 2, 1.0), horizon=8 * max(out.tau, 1.0),
        )
        print(f"stochastic pricing: {len(hops)} Markov-modulated hops, "
              f"{args.rollouts} rollouts, engine={args.engine}")

    def make_pricer(outcome, ov):
        return pricer_for(
            outcome, mode=args.pricing, overlay=ov,
            scenario=scenario, stochastic=sto, rollouts=args.rollouts,
            engine=args.engine,
            reduce="sample" if args.pricing == "stochastic" else "mean",
            device=dev,
        )

    # --- data / step / state ----------------------------------------------
    stream = SyntheticTokenStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   num_agents=m, dirichlet_alpha=0.3, seed=1)
    )
    loss_fn = lambda p, b: M.loss(cfg, p, {"tokens": b}, remat=False)[0]
    step_fn = make_dpsgd_step(loss_fn, learning_rate=0.05,
                              prox_mu=args.prox_mu)
    params = replicate_for_agents(M.init(cfg, 0, device=dev), m)

    ftc = FaultToleranceController(overlay, kappa, device=dev)
    ckdir = tempfile.mkdtemp(prefix="dfl_ckpt_")
    ck = AsyncCheckpointer(ckdir, keep=2)

    live = {"m": m}

    def batcher(k):
        return torch.as_tensor(
            np.stack([
                stream.batch(a % stream.cfg.num_agents, k, args.batch,
                             args.seq)
                for a in range(live["m"])
            ])
        )

    def intervene(k, params):
        """Failure injection: shrink the state, redesign on the
        survivors, and hand the trainer the new design's pricer — the
        charged τ switches on this very round."""
        if k == args.fail_agent_at and live["m"] > 2:
            print(f"[step {k}] injecting failure of agent 2")
            params, w, _ = ftc.handle_failures((2,), params, step=k)
            live["m"] -= 1
            surviving = build_overlay(
                underlay, [overlay.agents[a] for a in ftc.alive]
            )
            cats2 = compute_categories(surviving)
            out2 = outcome_from_matrix(w, cats2, kappa, live["m"], surviving,
                                       dev)
            print(f"redesign: rho={out2.rho:.3f} tau={out2.tau:.1f}s")
            return params, ("fmmd-wp-redesign", out2.design.matrix,
                            make_pricer(out2, surviving))
        if k % args.ckpt_every == 0 and k > 0:
            ck.save(k, {"params": params, "step": torch.tensor(k)})
        return params, None

    t_start = time.time()
    params, log = train_priced(
        params, step_fn, batcher, out.design.matrix,
        make_pricer(out, overlay),
        num_steps=args.steps,
        strategy=GossipStrategy(rounds=args.gossip_rounds),
        design_label=out.name, intervene=intervene, log_every=20,
        device=dev,
    )
    log.validate()
    ck.wait()

    for r in log.records:
        if r.step % 20 == 0 or r.step == args.steps - 1:
            print(
                f"step {r.step:4d} loss={r.loss:.4f} "
                f"consensus={r.consensus:.2e} design={r.design} "
                f"tau={r.tau:.1f}s [{r.pricing}] "
                f"modeled_wall={r.wall_clock/3600:.2f}h"
            )
    print(f"done in {time.time()-t_start:.0f}s wall; modeled "
          f"{log.total_wall/3600:.2f}h network time over "
          f"{len(log.records)} steps; checkpoints at {ckdir} "
          f"(latest step {latest_step(ckdir)})")
    if args.log_json:
        with open(args.log_json, "w") as f:
            f.write(log.to_json())
        print(f"replayable per-round τ log: {args.log_json}")


if __name__ == "__main__":
    main()
