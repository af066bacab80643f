"""D-PSGD (Lian et al.) — decentralized parallel SGD on one card.

Counterpart of the JAX package's ``core/dpsgd.py``. Update rule (paper
eq. (2)), which lets every agent overlap its gradient computation with
the parameter exchange:

    x_i^(k+1) = Σ_j W_ij x_j^(k) − η g(x_i^(k); ξ_i^(k)).

All m agents live on one device as a stacked tree of tensors with leading
axis m. The default form of the step ends in ONE fused kernel launch per
parameter leaf (``kernels.ops.mixing_sgd_combine_stacked``, gradient in
the kernel's momentum slot); the ``mix_first`` and ``prox_mu`` forms and
the FedDyn step (``make_feddyn_step``) need the mixed parameters on their
own and stay plain torch ops (``mix_params``), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import gossip
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class MixingPlan:
    """A mixing matrix W laid out on the device, built once per design.

    ``w`` is the dense float32 ``[A, A]`` matrix (for ``mix_params``);
    ``idx int32[A, R]`` / ``weights fp32[A, R+1]`` are
    ``gossip.neighbor_table(W)``, what the fused kernel reads.
    """

    w: torch.Tensor
    idx: torch.Tensor
    weights: torch.Tensor

    @property
    def num_agents(self) -> int:
        return self.w.shape[0]


def mixing_plan(
    w: np.ndarray | torch.Tensor, device: str | torch.device | None = None
) -> MixingPlan:
    """Build the device tables for W (host work: once per design or
    redesign, never per step)."""
    dev = compat.resolve_device(device)
    w_np = (
        w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
        else np.asarray(w)
    ).astype(np.float64)
    idx, weights = gossip.neighbor_table(w_np)
    return MixingPlan(
        w=torch.from_numpy(w_np.astype(np.float32)).to(dev),
        idx=torch.from_numpy(idx).to(dev),
        weights=torch.from_numpy(weights).to(dev),
    )


def mix_params(params: Any, w: torch.Tensor) -> Any:
    """Σ_j W_ij x_j per agent: dense mixing over the leading agent axis
    (W cast to the parameter dtype, as the reference does)."""
    return tree_map(
        lambda p: torch.einsum("ab,b...->a...", w.to(p.dtype), p), params
    )


def agent_grads(
    loss_fn: Callable[[Any, Any], torch.Tensor], params: Any, batch: Any
) -> tuple[torch.Tensor, Any]:
    """Per-agent losses ``[m]`` and gradients (stacked like ``params``).

    A loop over the leading agent axis: agent a differentiates
    ``loss_fn(params[a], batch[a])`` on its own. One agent's activations
    are alive at a time; the gradients are written into one stacked
    buffer per leaf, which is what the fused update reads.
    """
    leaves = tree_leaves(params)
    m = leaves[0].shape[0]
    grads = [torch.empty_like(p) for p in leaves]
    losses = []
    for a in range(m):
        p_a = [p[a].detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(
            tree_unflatten(params, p_a), tree_map(lambda b: b[a], batch)
        )
        g_a = torch.autograd.grad(loss, p_a, allow_unused=True)
        for buf, g in zip(grads, g_a):
            if g is None:
                buf[a].zero_()
            else:
                buf[a].copy_(g)
        losses.append(loss.detach())
    return torch.stack(losses), tree_unflatten(params, grads)


def fused_update(
    params: Any, grads: Any, plan: MixingPlan, eta: float
) -> Any:
    """Eq. (2) for every leaf: ``Σ_j W_ij x_j − η g_i`` in one streaming
    pass per leaf through the hand-written kernel."""

    def leaf(p, g):
        a = p.shape[0]
        out = ops.mixing_sgd_combine_stacked(
            p.reshape(a, -1), plan.idx, plan.weights, g.reshape(a, -1),
            lr=eta,
        )
        return out.reshape(p.shape)

    return tree_map(leaf, params, grads)


def plain_update(params: Any, grads: Any, w: torch.Tensor, eta: float) -> Any:
    """Eq. (2) unfused: ``mix_params`` then ``p − η g`` (two passes, two
    roundings) — the form the reference computes."""
    mixed = mix_params(params, w)
    return tree_map(lambda p, g: p - eta * g, mixed, grads)


def _to_device(batch: Any, device: torch.device) -> Any:
    return tree_map(lambda b: torch.as_tensor(b).to(device), batch)


def _lr_at(learning_rate: Callable[[int], float] | float, step: int) -> float:
    if callable(learning_rate):
        return float(learning_rate(step))
    return float(learning_rate)


def _require_plan(plan) -> None:
    if not isinstance(plan, MixingPlan):
        raise TypeError(
            "step_fn takes a MixingPlan (mixing_plan(w, device)), not "
            f"{type(plan).__name__}"
        )


def make_dpsgd_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    learning_rate: Callable[[int], float] | float = 0.1,
    mix_first: bool = False,
    prox_mu: float = 0.0,
) -> Callable:
    """Build a D-PSGD step ``step_fn(params, batch, plan, step)``.

    loss_fn(params_i, batch_i) -> scalar loss for ONE agent. ``plan`` is
    the ``MixingPlan`` of W, built once per design with ``mixing_plan``
    (a raw matrix is refused: its tables would be rebuilt and uploaded
    every step). ``step`` is a Python int; a scheduled learning rate is
    evaluated on the host.

    mix_first=False implements eq. (2) (exchange ∥ compute overlap);
    mix_first=True implements the equivalent rule x_i ← Σ_j W_ij (x_j − ηg_j)
    — same convergence, exposed for testing both forms.

    prox_mu > 0 adds a FedProx-style proximal term adapted to gossip:
    each agent's gradient is corrected by μ(x_i − Σ_j W_ij x_j), pulling
    the local update toward the neighborhood average it just received.
    μ = 0 recovers plain D-PSGD bitwise.
    """

    def step_fn(params: Any, batch: Any, plan: MixingPlan, step: int):
        _require_plan(plan)
        batch = _to_device(batch, tree_leaves(params)[0].device)
        loss, grads = agent_grads(loss_fn, params, batch)
        eta = _lr_at(learning_rate, step)
        with torch.no_grad():
            if mix_first:
                if prox_mu:
                    anchor = mix_params(params, plan.w)
                    grads = tree_map(
                        lambda g, p, a: g + prox_mu * (p - a),
                        grads, params, anchor,
                    )
                local = tree_map(lambda p, g: p - eta * g, params, grads)
                new_params = mix_params(local, plan.w)
            elif prox_mu:
                mixed = mix_params(params, plan.w)
                grads = tree_map(
                    lambda g, p, a: g + prox_mu * (p - a),
                    grads, params, mixed,
                )
                new_params = tree_map(
                    lambda p, g: p - eta * g, mixed, grads
                )
            else:
                new_params = fused_update(params, grads, plan, eta)
        return new_params, loss.mean()

    return step_fn


def feddyn_init(params: Any) -> Any:
    """Zero-initialized per-agent dynamic-regularization state for
    ``make_feddyn_step`` (same stacked tree shape as ``params``)."""
    return tree_map(torch.zeros_like, params)


def make_feddyn_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    learning_rate: Callable[[int], float] | float = 0.1,
    alpha: float = 0.01,
) -> Callable:
    """FedDyn-style dynamic regularization adapted to gossip.

    Each agent carries a corrective state h_i (initialized by
    ``feddyn_init``) that accumulates its historical drift from the
    neighborhood anchor a_i = Σ_j W_ij x_j:

        x_i ← a_i − η (g_i − h_i + α (x_i − a_i))
        h_i ← h_i − α (x_i⁺ − a_i)

    The state is strictly local: only x is gossiped, so the network price
    per round is plain D-PSGD's. The update needs the anchor on its own,
    which the fused kernel does not produce, so it is plain torch ops
    (``mix_params``), as in the reference.

    The returned step has signature ``step_fn((params, h), batch, plan,
    step) -> ((params, h), loss)`` — thread it through
    ``priced_training.train_priced`` with ``extract_params=lambda c:
    c[0]``.
    """

    def step_fn(carry: Any, batch: Any, plan: MixingPlan, step: int):
        _require_plan(plan)
        params, h = carry
        batch = _to_device(batch, tree_leaves(params)[0].device)
        loss, grads = agent_grads(loss_fn, params, batch)
        eta = _lr_at(learning_rate, step)
        with torch.no_grad():
            anchor = mix_params(params, plan.w)
            new_params = tree_map(
                lambda a, g, hh, p: a - eta * (g - hh + alpha * (p - a)),
                anchor, grads, h, params,
            )
            new_h = tree_map(
                lambda hh, x, a: hh - alpha * (x - a), h, new_params, anchor
            )
        return (new_params, new_h), loss.mean()

    return step_fn


def consensus_distance(params: Any) -> torch.Tensor:
    """‖x_i − x̄‖² averaged over agents — the disagreement D-PSGD drives down."""
    def per_leaf(p):
        mean = p.mean(dim=0, keepdim=True)
        return ((p - mean) ** 2).sum()

    leaves = tree_leaves(params)
    m = leaves[0].shape[0]
    return sum(per_leaf(p) for p in leaves) / m


def replicate_for_agents(params: Any, m: int) -> Any:
    """Stack identical initial parameters for m agents (standard init).
    Every leaf is materialised contiguous: agents diverge from step one."""
    return tree_map(
        lambda p: p.unsqueeze(0).expand(m, *p.shape).contiguous(), params
    )


@dataclasses.dataclass
class TrainLog:
    steps: list
    losses: list
    consensus: list
    wall_time: list  # modeled wall-clock (Σ per-iteration τ)


def train(
    params: Any,
    step_fn: Callable,
    batcher: Callable[[int], Any],
    w: np.ndarray,
    num_steps: int,
    tau_per_iteration: float = 0.0,
    log_every: int = 10,
    device: str | torch.device | None = None,
) -> tuple[Any, TrainLog]:
    """Simulation-mode D-PSGD training loop with modeled wall-clock time."""
    dev = compat.resolve_device(device)
    params = tree_map(lambda p: p.to(dev), params)
    plan = mixing_plan(w, dev)
    log = TrainLog([], [], [], [])
    for k in range(num_steps):
        batch = batcher(k)
        params, loss = step_fn(params, batch, plan, k)
        if k % log_every == 0 or k == num_steps - 1:
            log.steps.append(k)
            log.losses.append(float(loss))
            log.consensus.append(float(consensus_distance(params)))
            log.wall_time.append((k + 1) * tau_per_iteration)
    return params, log
