"""Fig. 5: training quality vs epochs AND vs wall-clock under each design.

The port's copy of the JAX package's ``benchmarks/fig5_training.py``. A
small transformer LM (same D-PSGD machinery, every update through the
``mixing_sgd_combine`` kernel on the GPU) trains on non-IID synthetic data
over each scheme's designed W, and reports loss vs (a) steps and (b)
modeled wall-clock. Reproduced headline: sparse designs (FMMD/SCA) reach
the same loss as Clique at a fraction of the wall-clock; FMMD ≈ SCA.

Each scheme's per-round τ comes from the same ``evaluate_design`` pricing
path the designer uses — the routed static τ by default, the
scenario-simulated τ when ``run(scenario=...)`` is set (``PhasedTau``),
or the seeded expectation when ``run(stochastic=...)`` is set — never a
hand-picked constant. ``device=None`` means CUDA: the weight
optimizations of the designs and the training run there.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import design, make_dpsgd_step, replicate_for_agents
from repro_torch.core.priced_training import pricer_for, train_priced
from repro_torch.data import DataConfig, SyntheticTokenStream
from repro_torch.models import model
from repro_torch.paper.scenario import (
    CONSTANTS,
    KAPPA,
    NUM_AGENTS,
    paper_scenario,
)

SMALL_LM = ModelConfig(
    name="bench-lm",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_pattern=("attn",),
    rope_theta=1e4,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)

SCHEMES = ("clique", "ring", "prim", "fmmd-wp", "sca")


def run(steps: int = 120, scenario=None, stochastic=None,
        stochastic_rollouts: int = 8, engine: str = "batched",
        device: str | torch.device | None = None) -> dict:
    _, ov, cats = paper_scenario()
    mode = (
        "phased" if scenario is not None
        else "stochastic" if stochastic is not None
        else "static"
    )
    stream = SyntheticTokenStream(
        DataConfig(vocab_size=SMALL_LM.vocab_size, seq_len=32,
                   num_agents=NUM_AGENTS, dirichlet_alpha=0.3, seed=5)
    )

    def loss_fn(p, b):
        return model.loss(SMALL_LM, p, {"tokens": b}, remat=False)[0]

    step_fn = make_dpsgd_step(loss_fn, learning_rate=0.1)

    def batcher(k):
        return stream.stacked_batch(k, per_agent_batch=4)

    results = {}
    for method in SCHEMES:
        out = design(method, cats, KAPPA, NUM_AGENTS, overlay=ov,
                     iterations=12, constants=CONSTANTS,
                     scenario=scenario, stochastic=stochastic,
                     stochastic_rollouts=stochastic_rollouts,
                     engine=engine, device=device)
        pricer = pricer_for(out, mode=mode, overlay=ov,
                            scenario=scenario, stochastic=stochastic,
                            engine=engine, device=device)
        params = replicate_for_agents(
            model.init(SMALL_LM, 0, device=device), NUM_AGENTS
        )
        _, log = train_priced(
            params, step_fn, batcher, out.design.matrix, pricer,
            num_steps=steps, design_label=out.name, log_every=10,
            device=device,
        )
        log.validate()
        results[method] = dict(
            losses=log.losses, steps=log.steps, wall_clock=log.wall_clock,
            tau=out.tau, tau_bar=out.tau_bar, rho=out.rho,
            tau_model=pricer.kind,
            final_loss=log.losses[-1],
            time_to_final=log.total_wall,
            log=log,
            outcome=out,
        )
    return results

