"""D-PSGD training step of the launcher, on one card.

Counterpart of the JAX package's ``launch/train.py``. One step per agent
(paper eq. (2), compute ∥ exchange form):

  1. per-agent gradients over the stacked agent axis — a loop over the
     agents, so one agent's activations are alive at a time — with
     gradient accumulation over ``microbatch`` chunks,
  2. local SGD-momentum update (``optim.sgd``),
  3. gossip mixing of the parameters — sparse (one launch of the
     ``mixing_sgd_combine`` kernel per leaf, neighbour rows read in
     place), dense einsum, or all-reduce (W = J), per the designed mixing
     matrix.

State: ``{"params": [A, ...], "opt": {"momentum": [A, ...]}, "step": int}``
— stacked leading agent axis A on every leaf; the step counter is a
Python int on the host, and so is the learning rate it selects.

``build_train_artifacts`` returns the step function, the shapes of the
state and the batch (``meta`` tensors), and ``init_state``. The
reference's shardings, ``jit`` and ``lower`` have no counterpart on one
card: every agent is a row of the stacked leaves (``launch/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import dpsgd, gossip
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainArtifacts:
    step_fn: Callable          # (state, batch) -> (state, metrics)
    state_shapes: Any          # meta tensors (stacked agents); "step": 0
    batch_shapes: Any          # {"tokens": meta int32 [A, k, mb, S+1], ...}
    num_agents: int
    mixing_matrix: np.ndarray | None
    gossip: str                # resolved mode: none/allreduce/dense/sparse
    init_state: Callable[[int], Any]  # seed -> concrete state on device


def _batch_shapes(
    cfg: ModelConfig, shape: ShapeConfig, num_agents: int, microbatch: int
) -> dict:
    """The reference's batch: ``tokens [A, k, mb, S + 1]``; for the VLM
    ``tokens [A, k, mb, S - num_patches + 1]`` and ``patch_embeds [A, k, mb,
    num_patches, d_model]`` (the patches fill the first positions)."""
    per_agent = shape.global_batch // max(num_agents, 1)
    k = max(microbatch, 1)
    if per_agent % k != 0:
        k = 1
    mb = per_agent // k
    lead = (num_agents, k, mb)
    if cfg.frontend != "vision_patches":
        return {"tokens": torch.empty((*lead, shape.seq_len + 1),
                                      dtype=torch.int32, device="meta")}
    text = shape.seq_len - cfg.num_patches
    return {
        "tokens": torch.empty((*lead, text + 1), dtype=torch.int32,
                              device="meta"),
        "patch_embeds": torch.empty((*lead, cfg.num_patches, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta"),
    }


def _stacked_state_shapes(cfg: ModelConfig, num_agents: int) -> dict:
    params = tree_map(
        lambda p: torch.empty(
            (num_agents, *p.shape), dtype=p.dtype, device="meta"
        ),
        model.init(cfg, 0, device="meta"),
    )
    return {"params": params, "opt": sgd.init(params), "step": 0}


def resolve_gossip(
    mode: str, mixing_matrix: np.ndarray | None, m: int
) -> tuple[str, np.ndarray | None]:
    """The reference's resolution of ``tcfg.gossip`` against W: ``(mode,
    W as float64)``; ``auto`` picks all-reduce for W = J, sparse for any
    support short of the clique, dense for the clique."""
    if mixing_matrix is None or m <= 1:
        return "none", None
    w_arr = np.asarray(mixing_matrix, np.float64)
    if mode == "auto":
        is_j = np.allclose(w_arr, np.full((m, m), 1.0 / m), atol=1e-9)
        nnz = np.count_nonzero(
            np.abs(w_arr - np.diag(np.diag(w_arr))) > 1e-12
        )  # directed activated edges
        mode = (
            "allreduce" if is_j else
            ("sparse" if nnz < m * (m - 1) else "dense")
        )
    if mode not in ("none", "allreduce", "dense", "sparse"):
        raise ValueError(f"unknown gossip mode {mode!r}")
    return mode, w_arr


def build_train_artifacts(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    shape: ShapeConfig,
    mesh: mesh_lib.Mesh,
    mixing_matrix: np.ndarray | None = None,
    learning_rate: Callable[[int], float] | None = None,
    device: str | torch.device | None = None,
) -> TrainArtifacts:
    """Assemble the train step for one (arch × shape) cell on ``device``
    (``None`` means CUDA and raises without a card).

    ``mixing_matrix`` must be m×m for m = number of agents implied by the
    layout and mesh; None ⇒ identity (no gossip; m=1 cells).
    ``learning_rate(step)`` is a host function (``optim.schedule``).
    """
    dev = compat.resolve_device(device)
    m = mesh_lib.num_agents(mesh, tcfg.agent_layout)
    if mixing_matrix is not None and mixing_matrix.shape[0] != m:
        raise ValueError(
            f"mixing matrix is {mixing_matrix.shape[0]}x…, layout implies m={m}"
        )
    mode, w_arr = resolve_gossip(tcfg.gossip, mixing_matrix, m)
    plan = dpsgd.mixing_plan(w_arr, dev) if w_arr is not None else None
    lr_fn = learning_rate or (lambda step: tcfg.learning_rate)
    remat = tcfg.remat != "none"
    # data_dp: accumulate fp32 per agent, hand the update bf16 gradients
    # (the reference's cast for its bf16 all-reduce; it changes the values
    # on one card too).
    grad_dtype = (
        torch.bfloat16 if tcfg.agent_layout == "data_dp" else torch.float32
    )

    def grads_fn(params, batch):
        """Per-agent mean losses ``[A]`` and gradients accumulated over the
        k microbatches (``a + g.f32 / k``), stacked like ``params``."""
        leaves = tree_leaves(params)
        n_agents, k = batch["tokens"].shape[:2]
        grads = [
            torch.empty(p.shape, dtype=grad_dtype, device=p.device)
            for p in leaves
        ]
        losses = torch.empty(n_agents, dtype=torch.float32, device=dev)
        for a in range(n_agents):
            p_a = [p[a].detach().requires_grad_(True) for p in leaves]
            tree_a = tree_unflatten(params, p_a)
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in p_a]
            loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(k):
                loss, _ = model.loss(
                    cfg, tree_a, {key: v[a, i] for key, v in batch.items()},
                    moe_aux_weight=tcfg.moe_aux_weight,
                    router_z_weight=tcfg.router_z_weight, remat=remat,
                )
                g = torch.autograd.grad(loss, p_a, allow_unused=True)
                with torch.no_grad():
                    loss_acc = loss_acc + loss.detach() / k
                    for buf, gi in zip(acc, g):
                        if gi is not None:
                            buf.add_(gi.to(torch.float32) / k)
                del loss, g
            with torch.no_grad():
                for out, buf in zip(grads, acc):
                    out[a].copy_(buf)
                losses[a] = loss_acc
            del acc, p_a, tree_a
        return losses, tree_unflatten(params, grads)

    def mix_fn(params):
        with torch.no_grad():
            if mode == "allreduce":
                return gossip.mix_allreduce(params)
            if mode == "dense":
                return gossip.mix_dense(params, plan.w)
            if mode == "sparse":
                return gossip.mix_sparse(params, plan.idx, plan.weights)
            return params

    def step_fn(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads = grads_fn(params, batch)
        lr = sgd.host_lr(lr_fn(step))
        new_params, new_opt = sgd.update(
            grads, opt, params, lr, momentum=tcfg.momentum
        )
        del grads
        # Gossip mixing (paper eq. (2)): mix the post-update parameters.
        new_params = mix_fn(new_params)
        new_state = {"params": new_params, "opt": new_opt, "step": step + 1}
        return new_state, {"loss": loss.mean(), "lr": lr}

    def init_state(seed: int) -> dict:
        """Identical init across agents (standard D-PSGD start): one
        ``model.init`` from ``seed``, stacked m times."""
        params = dpsgd.replicate_for_agents(model.init(cfg, seed, device=dev), m)
        return {"params": params, "opt": sgd.init(params), "step": 0}

    return TrainArtifacts(
        step_fn=step_fn,
        state_shapes=_stacked_state_shapes(cfg, m),
        batch_shapes=_batch_shapes(cfg, shape, m, tcfg.microbatch),
        num_agents=m,
        mixing_matrix=w_arr,
        gossip=mode,
        init_state=init_state,
    )
