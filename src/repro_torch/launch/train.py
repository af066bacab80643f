"""D-PSGD training step of the launcher, on one card or across ranks.

Counterpart of the JAX package's ``launch/train.py``. One step per agent
(paper eq. (2), compute ∥ exchange form):

  1. per-agent gradients — a loop over the agents, so one agent's
     activations are alive at a time — with gradient accumulation over
     ``microbatch`` chunks,
  2. local SGD-momentum update (``optim.sgd``),
  3. gossip mixing of the parameters — sparse, dense einsum, or
     all-reduce (W = J), per the designed mixing matrix.

``build_train_artifacts`` takes either kind of mesh (``launch/mesh.py``):

* a ``Mesh`` description: all m agents on one card, stacked on dim 0 of
  every leaf; the sparse gossip is one launch of the
  ``mixing_sgd_combine`` kernel per leaf with neighbour rows read in
  place (``gossip.mix_sparse``).
* a ``DeviceMesh`` (``mesh.init_mesh``): each rank holds the leaves
  ``[1, …]`` of one agent — whole under ``data_dp``, its ``model`` part
  under ``data`` (``sharding.shard_tree(state, art.param_specs, mesh)``
  of the stacked tree; tensor parallelism, ``models/sharding_hints.py``).
  The step takes the rank's part of the batch (``sharding.shard_tree(
  batch, art.batch_specs, mesh)``): ``tokens[agent, :, model-slice, :]``
  under ``data_dp``, where each rank's gradients are accumulated in
  float32, scaled to its share of the microbatch, cast to bf16 and summed
  over the ``model`` group; the agent's whole microbatch on each of its
  ``model`` ranks under ``data``, whose replicated leaves (norms, the
  router) get the same gradient on every rank through the conjugate pair.
  Under ``pod`` one agent spans a pod's ``data`` × ``model`` ranks: each
  holds its FSDP × TP part of every leaf (experts split along E over
  ``data`` where E divides: expert parallelism) and its ``data`` share of
  every microbatch (all of it where the microbatch does not divide), its
  loss weighted 1/|data|; the FSDP leaves' gradients are summed by their
  gather's reduce-scatter, the experts' by the all-to-all back to their
  owner, and only the leaves whole over ``data`` are all-reduced over it
  (float32). The sparse gossip crosses ranks by point-to-point exchanges
  (``gossip.mix_sparse_flat`` under ``data_dp``, ``gossip.mix_sparse_p2p``
  under ``data`` and ``pod``, each coordinate off the agent axes
  gossiping its part of every leaf); the loss in the metrics is the mean
  over every rank.

State: ``{"params": [A, ...], "opt": {"momentum": [A, ...]}, "step": int}``
— A agents stacked (A = 1 on a rank); the step counter is a Python int on
the host, and so is the learning rate it selects.

``build_train_artifacts`` returns the step function, the shapes of the
state and the global batch (``meta`` tensors), their partition specs
(``launch/sharding.py``), and ``init_state``. The reference's
``NamedSharding``s, ``jit`` and ``lower`` have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import compat
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import dpsgd, gossip
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import model
from repro_torch.models.sharding_hints import hints
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
    param_specs: Any           # sharding.P per stacked parameter leaf
    batch_specs: Any           # sharding.P per batch leaf (microbatch dim)


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


def _batch_specs(batch_shapes: dict, mesh, layout: str) -> dict:
    """The reference's batch specs with the microbatch dim inserted."""
    specs = sharding.batch_specs_train(
        {k: torch.empty((v.shape[0], *v.shape[2:]), device="meta")
         for k, v in batch_shapes.items()},
        mesh, layout,
    )
    return {k: sharding.P(spec[0], None, *spec[1:])
            for k, spec in specs.items()}


def _reduce_gradients(grads, group) -> None:
    """Sum every gradient leaf of ``grads`` (a tree or a list) over
    ``group`` in place (the ``model`` group under ``data_dp``; the leaves
    whole over ``data`` under ``pod``)."""
    for g in tree_leaves(grads):
        mesh_lib.group_all_reduce(g, group)


def build_train_artifacts(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    shape: ShapeConfig,
    mesh: mesh_lib.Mesh | DeviceMesh,
    mixing_matrix: np.ndarray | None = None,
    learning_rate: Callable[[int], float] | None = None,
    device: str | torch.device | None = None,
) -> TrainArtifacts:
    """Assemble the train step for one (arch × shape) cell on ``device``
    (``None`` means CUDA and raises without a card): all agents on one
    card for a ``Mesh`` description, this rank's agent for a
    ``DeviceMesh`` (whose device type must match ``device``).

    ``mixing_matrix`` must be m×m for m = number of agents implied by the
    layout and mesh; None ⇒ identity (no gossip; m=1 cells).
    ``learning_rate(step)`` is a host function (``optim.schedule``).
    """
    dev = compat.resolve_device(device)
    layout = tcfg.agent_layout
    m = mesh_lib.num_agents(mesh, layout)
    if mixing_matrix is not None and mixing_matrix.shape[0] != m:
        raise ValueError(
            f"mixing matrix is {mixing_matrix.shape[0]}x…, layout implies m={m}"
        )
    state_shapes = _stacked_state_shapes(cfg, m)
    batch_shapes = _batch_shapes(cfg, shape, m, tcfg.microbatch)
    param_specs = sharding.param_specs_train(
        state_shapes["params"], mesh, layout)
    batch_specs = _batch_specs(batch_shapes, mesh, layout)
    on_ranks = isinstance(mesh, DeviceMesh)
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

    def grads_fn(params, batch, share: float = 1.0):
        """Per-agent mean losses ``[A]`` and gradients accumulated over the
        k microbatches (``a + g.f32 / k``; each ``g`` scaled by ``share``
        first when the batch holds that share of every microbatch),
        stacked like ``params``."""
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
            # float32 gradients accumulate in place in their output row;
            # bf16 ones in float32 buffers, cast once at the end
            acc = [out[a].zero_() if grad_dtype == torch.float32 else
                   torch.zeros_like(p, dtype=torch.float32)
                   for out, p in zip(grads, p_a)]
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
                            gi = gi.to(torch.float32)
                            if share != 1.0:
                                gi = gi * share
                            buf.add_(gi / k)
                del loss, g
            with torch.no_grad():
                if grad_dtype != torch.float32:
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

    if on_ranks:
        step_fn = _mesh_step(
            mesh, layout, mode, w_arr, plan, batch_specs, param_specs,
            grads_fn, lr_fn, tcfg.momentum, dev)
    agents_here = 1 if on_ranks else m

    def init_state(seed: int) -> dict:
        """Identical init across agents (standard D-PSGD start): one
        ``model.init`` from ``seed``, stacked for the agents held here
        (all m on one card, this rank's one on a ``DeviceMesh``, at its
        part of each leaf)."""
        params = dpsgd.replicate_for_agents(
            model.init(cfg, seed, device=dev), agents_here)
        if on_ranks:
            mine = tree_map(lambda s: sharding.P(None, *s[1:]), param_specs)
            params = tree_map(lambda p: p.clone(),
                              sharding.shard_tree(params, mine, mesh))
        return {"params": params, "opt": sgd.init(params), "step": 0}

    return TrainArtifacts(
        step_fn=step_fn,
        state_shapes=state_shapes,
        batch_shapes=batch_shapes,
        num_agents=m,
        mixing_matrix=w_arr,
        gossip=mode,
        init_state=init_state,
        param_specs=param_specs,
        batch_specs=batch_specs,
    )


def _mesh_step(mesh, layout, mode, w_arr, plan, batch_specs, param_specs,
               grads_fn, lr_fn, momentum, dev) -> Callable:
    """The step of one rank of a ``DeviceMesh`` (module docstring)."""
    agent_axes = mesh_lib.agent_axes(mesh, layout)
    sizes = mesh_lib.axis_sizes(mesh)
    # per leaf: is its gradient summed over ``reduce_group`` here?
    reduced = tree_map(lambda _: True, param_specs)
    share, reduce_group, fsdp = 1.0, None, None
    if layout == "pod":
        # Each data rank's loss weighs 1/|data| (its share of the rows, or
        # one of |data| copies of them); only the leaves whole over "data"
        # are summed over it here.
        share = 1.0 / sizes["data"]
        if sizes["data"] > 1:
            reduce_group = mesh_lib.axis_group(mesh, ("data",))
            reduced = tree_map(
                lambda s: not sharding.split_over(s, mesh, ("data",)),
                param_specs)
            fsdp = sharding.fsdp_plan(param_specs, mesh, ("data",), lead=1)
    elif batch_specs["tokens"][2] is not None:
        # data_dp: each "model" rank holds 1/M of every microbatch and the
        # gradients are summed over the "model" group.
        split = batch_specs["tokens"][2]
        share = 1.0 / sizes[split]
        reduce_group = mesh_lib.axis_group(mesh, (split,))
    schedule = gossip.build_schedule(w_arr) if mode == "sparse" else None
    # The reference's activation hints per layout: the batch role on
    # "data" (pod), on the repurposed "model" axis (data_dp) or nowhere
    # (data); FSDP and EP over "data" under pod.
    role_axes = {"batch": {"pod": ("data",), "data_dp": ("model",),
                           "data": ()}[layout],
                 "tp": () if layout == "data_dp" else ("model",),
                 "seq": () if layout == "data_dp" else ("model",)}
    if layout == "pod":
        role_axes.update(fsdp=("data",), ep=("data",))
    world = dist.get_world_size()

    def mix_fn(params):
        with torch.no_grad():
            if mode == "allreduce":
                return gossip.mix_allreduce(params, mesh, agent_axes)
            if mode == "dense":
                return gossip.mix_dense(params, plan.w, mesh, agent_axes)
            if mode == "sparse" and layout == "data_dp":
                # Replicated over "model": gossip the raveled tree, each
                # replica its slice.
                return gossip.mix_sparse_flat(
                    params, schedule, mesh, agent_axes, ("model",))
            if mode == "sparse":
                return gossip.mix_sparse_p2p(
                    params, schedule, mesh, agent_axes)
            return params

    def step_fn(state, batch):
        """``batch`` is this rank's part of the global batch."""
        params, opt, step = state["params"], state["opt"], state["step"]
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        with hints(role_axes, mesh, fsdp):
            loss, grads = grads_fn(params, batch, share)
        if reduce_group is not None:
            # ``reduced`` in the gradients' leaf order (matched by key)
            keep = tree_leaves(tree_map(lambda _, r: r, grads, reduced))
            _reduce_gradients([g for g, r in zip(tree_leaves(grads), keep)
                               if r], reduce_group)
        lr = sgd.host_lr(lr_fn(step))
        new_params, new_opt = sgd.update(
            grads, opt, params, lr, momentum=momentum
        )
        del grads
        new_params = mix_fn(new_params)
        loss = loss.mean()
        mesh_lib.group_all_reduce(loss, None)  # equal shares: every rank's
        new_state = {"params": new_params, "opt": new_opt, "step": step + 1}
        return new_state, {"loss": loss / world, "lr": lr}

    return step_fn
