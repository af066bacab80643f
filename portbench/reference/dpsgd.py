"""The reference D-PSGD step (paper eq. (2), compute then exchange): each
agent's gradient of its mean token loss, the local SGD-momentum update m ←
μ·m + g, x ← x − lr·m, then the gossip x_i ← Σ_j W_ij x_j over every
agent. Everything is computed in float32; the state (parameters and
momentum) is stored in the dtype the configuration states for it
(``param_dtype``), rounded where it is stored: the parameters after the
update (which takes the momentum unrounded) and after the gossip, the
momentum after the update. It
follows the program's first steps from the same parameters, W and tokens
and returns what ``checks`` compares."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.common import Matmul, strict_fp32


def _stored(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as stored in ``dtype`` and read back."""
    return x if dtype == x.dtype else x.to(dtype).to(x.dtype)


def follow(arch, model: dict, params0: dict, w: np.ndarray, batches: list,
           lr: float, momentum: float, mm: Matmul | None = None) -> dict:
    """``len(batches)`` steps from ``params0`` (``{path: one agent's
    leaf}``, copied to every agent) over ``batches`` (``[A, B, S + 1]``
    tokens a step) → ``{"loss": [[A] each agent's loss] a step, "grad": {path:
    [A] norms of each agent's first gradient}, "change": {path: [A] norms
    of each agent's change over all the steps}}``, on the host."""
    strict_fp32()
    mm = mm or Matmul()
    state_dtype = getattr(torch, model["param_dtype"])
    agents = w.shape[0]
    p0 = {k: v.to(torch.float32) for k, v in params0.items()}
    params = {k: v[None].expand(agents, *v.shape).clone() for k, v in p0.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    wt = torch.as_tensor(w, dtype=torch.float32,
                         device=next(iter(p0.values())).device)
    losses, first = [], None
    for tokens in batches:
        step_losses = np.zeros(agents)
        norms = {k: np.zeros(agents) for k in params}
        for a, loss, grads in arch.agent_grads(params, tokens, model, mm):
            step_losses[a] = loss
            with torch.no_grad():
                for k, g in grads.items():
                    norms[k][a] = float(g.norm())
                    mom[k][a].mul_(momentum).add_(g)
            del grads
        first = first or norms
        with torch.no_grad():
            for k in params:
                params[k] = _stored(params[k].add_(mom[k], alpha=-lr),
                                    state_dtype)
                mom[k] = _stored(mom[k], state_dtype)
                params[k] = _stored(
                    torch.einsum("ab,b...->a...", wt, params[k]), state_dtype)
        losses.append(step_losses.tolist())
    with torch.no_grad():
        change = {k: np.array([float((v[a] - p0[k]).norm())
                               for a in range(agents)])
                  for k, v in params.items()}
    return {"loss": losses, "grad": first, "change": change}
