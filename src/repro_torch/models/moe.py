"""Mixture-of-Experts FFN with top-k routing and sort-based dispatch.

Counterpart of the JAX package's ``models/moe.py``, the same static-shape
formulation: tokens are routed to experts by sorting each row's (token,
choice) list by expert id; dispatch and combine are row-wise gathers,
with scatters confined to small integer index vectors. Capacity C =
int(S·top_k/E·cf) per row (at least top_k); overflow choices are dropped.
Aux: Switch load-balance + router z-loss.

Where the port departs from the reference's calls, not its results:

* ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` does not promise that on CUDA, so the
  choice is a stable descending sort cut to its first k (``route``).
* The ``.at[...].set(mode="drop")`` scatters write into a buffer with one
  sentinel column more, which is then sliced off (``dispatch_indices``).
* The gathers index rows (``x[rows, idx]``), never ``torch.gather`` with
  an index expanded to ``d``: at the served prefill that index alone would
  be ``[4, 20480, 4096]`` int64, 2.7 GB.
* ``constrain(...)`` stands where the reference pins the batch dim of
  the dispatch buffers; on the port's local tensors it is the identity
  (``models/sharding_hints.py``).

Tensor parallelism splits the experts along F (``gate``/``up``'s columns,
``down``'s rows). The router stays whole: every rank routes, sizes and
drops alike from the same input, feeds the dispatched rows through
``copy_to_tp`` to its F block, and sums the experts' outputs with
``reduce_from_tp`` right after ``down``, before the gates weigh them (so
the router's gradient is whole on every rank).

Expert parallelism (the ``pod`` layout, serving's 2-D tensor
parallelism) splits the experts along E over the "ep" axes: a rank holding
E/n of them sends each owner its experts' block of the dispatch buffer
(``ep_dispatch``, an all-to-all), runs its experts on every rank's rows
and sends the outputs back (``ep_combine``) before the combine gather.
Routing stays per row, so nothing else crosses ranks. Where the rows of a
microbatch are split over ranks, the top-1 share of tokens ``me`` of the
load-balance loss is averaged over them (``batch_mean``) before it
weighs the rank's mean probabilities, as the reference's loss is one
product over the whole microbatch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models import sharding_hints as sh
from repro_torch.models.sharding_hints import constrain

# Above this many elements of one expert's [cap, d_ff] intermediate the
# experts run one after another (the same flops, E× less live memory), as
# the reference's ``cap * d_ff > 128 * 1024 * 1024`` rule.
LOOP_EXPERTS_ABOVE = 128 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


def init(generator, spec: MoESpec, dtype, device, lead=()) -> dict:
    e, d, f = spec.num_experts, spec.d_model, spec.d_ff
    return {
        "router": layers.dense_init(generator, d, e, dtype, device, lead),
        # Stacked expert SwiGLU weights: [*lead, E, d, f] / [*lead, E, f, d].
        "gate": layers.truncated_normal_init(
            generator, (*lead, e, d, f), d**-0.5, dtype, device
        ),
        "up": layers.truncated_normal_init(
            generator, (*lead, e, d, f), d**-0.5, dtype, device
        ),
        "down": layers.truncated_normal_init(
            generator, (*lead, e, f, d), f**-0.5, dtype, device
        ),
    }


def capacity(tokens: int, spec: MoESpec) -> int:
    c = int(tokens * spec.top_k / spec.num_experts * spec.capacity_factor)
    return max(c, spec.top_k)


def route(params: dict, xt: torch.Tensor, spec: MoESpec):
    """xt: [..., D] in the compute dtype → (float32 router logits, their
    softmax, the top-k gates renormalised to sum 1, the top-k expert ids),
    the ids in descending probability, the lower id first among equals."""
    logits = layers.dense_apply(params["router"], xt, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = top[..., : spec.top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return logits, probs, gate_vals, idx[..., : spec.top_k]


def dispatch_indices(expert_idx: torch.Tensor, cap: int, num_experts: int):
    """expert_idx: [B, N, k] → (``token_for_slot`` int32 [B, E·C]: the
    token each expert slot reads, N where the slot is empty;
    ``slot_for_choice`` int32 [B, N·k]: the slot each (token, choice)
    pair was given, E·C where it was dropped). Within an expert, slots go
    to choices in (token, choice) order."""
    b, n, k = expert_idx.shape
    e, dev = num_experts, expert_idx.device
    flat_expert = expert_idx.reshape(b, n * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)        # [b, nk]
    sorted_expert = torch.gather(flat_expert, 1, order)
    # Position within each expert's run: index − first index of the run.
    ar = torch.arange(n * k, device=dev).expand(b, n * k)
    change = torch.ones((b, n * k), dtype=torch.bool, device=dev)
    change[:, 1:] = sorted_expert[:, 1:] != sorted_expert[:, :-1]
    run_start = torch.cummax(torch.where(change, ar, 0), dim=-1).values
    positions = ar - run_start
    slot = torch.where(positions < cap, sorted_expert * cap + positions,
                       e * cap)
    rows = torch.arange(b, device=dev)[:, None]
    # slot -> source token; dropped choices land in the sentinel column.
    token_for_slot = torch.full((b, e * cap + 1), n, dtype=torch.int32,
                                device=dev)
    token_for_slot[rows, slot] = (order // k).to(torch.int32)
    # (token, choice) -> slot: ``order`` is a permutation of each row.
    slot_for_choice = torch.empty((b, n * k), dtype=torch.int32, device=dev)
    slot_for_choice.scatter_(1, order, slot.to(torch.int32))
    return token_for_slot[:, : e * cap], slot_for_choice


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    """[B, R, D] → [B, R + 1, D] with a zero row last (the sentinel)."""
    return torch.cat([t, t.new_zeros((t.shape[0], 1, t.shape[2]))], dim=1)


def apply(
    params: dict, x: torch.Tensor, spec: MoESpec, compute_dtype,
    with_aux: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """x: [B, S, D] -> (y, aux); aux = {load_balance_loss, router_z_loss},
    or None without ``with_aux`` (the serving forms, whose aux the
    reference computes and drops).

    Dispatch groups are batch rows: capacity is per row and routing never
    crosses rows.
    """
    b, n, d = x.shape
    e = spec.num_experts
    cap = capacity(n, spec)
    xt = constrain(x.to(compute_dtype), ("batch", None, None))
    router_logits, probs, gate_vals, expert_idx = route(params, xt, spec)
    token_for_slot, slot_for_choice = dispatch_indices(expert_idx, cap, e)
    rows = torch.arange(b, device=x.device)[:, None]

    # ---- dispatch gather -------------------------------------------------
    xin = _pad_row(xt)[rows, token_for_slot.long()]           # [b, E·C, d]
    xin = constrain(xin, ("batch", None, None)).reshape(b, e, cap, d)
    partial = sh.local_range(params["down"].shape[-2], spec.d_ff)[2]
    if partial:
        xin = sh.copy_to_tp(xin)
    owners = sh.ep_size(params["down"].shape[-3], e)
    if owners > 1:
        xin = sh.ep_dispatch(xin)               # [owners·b, E/owners, C, d]

    # ---- expert SwiGLU ---------------------------------------------------
    # Each weight is cast to the compute dtype where it is used, so at most
    # one cast copy is alive (a float32 forward of bf16 weights: Jamba's
    # stacked experts are 12.9 GB each in float32).
    def w(name, *i):
        return params[name][i].to(compute_dtype)

    if cap * spec.d_ff > LOOP_EXPERTS_ABOVE:
        yout = torch.stack([
            (F.silu(xin[:, i] @ w("gate", i)) * (xin[:, i] @ w("up", i)))
            @ w("down", i)
            for i in range(xin.shape[1])
        ], dim=1)                                             # [b, e, cap, d]
    else:
        # one expression: only the product stays alive for the last einsum
        h = F.silu(torch.einsum("becd,edf->becf", xin, w("gate"))) * (
            torch.einsum("becd,edf->becf", xin, w("up")))
        yout = torch.einsum("becf,efd->becd", h, w("down"))

    if partial:
        yout = sh.reduce_from_tp(yout)
    if owners > 1:
        yout = sh.ep_combine(yout)
    yout = constrain(yout.reshape(b, e * cap, d), ("batch", None, None))

    # ---- combine gather ---------------------------------------------------
    per_choice = _pad_row(yout)[
        rows, slot_for_choice.long()
    ].reshape(b, n, spec.top_k, d)
    y = torch.einsum("bnk,bnkd->bnd", gate_vals.to(compute_dtype), per_choice)
    y = constrain(y, ("batch", None, None))

    if not with_aux:
        return y, None
    # ---- aux losses --------------------------------------------------------
    me = sh.batch_mean(
        F.one_hot(expert_idx[..., 0], e).to(torch.float32).mean(dim=(0, 1)))
    ce = probs.mean(dim=(0, 1))
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "router_z_loss": torch.logsumexp(router_logits, dim=-1)
        .square()
        .mean(),
    }
    return y, aux


def apply_dense_reference(
    params: dict, x: torch.Tensor, spec: MoESpec, compute_dtype
) -> torch.Tensor:
    """No-capacity loop-over-experts oracle (tests only; O(n·E·d·f))."""
    b, s, d = x.shape
    xt = x.reshape(-1, d).to(compute_dtype)
    _, _, gate_vals, expert_idx = route(params, xt, spec)
    y = torch.zeros_like(xt)
    for ei in range(spec.num_experts):
        g = F.silu(xt @ params["gate"][ei].to(compute_dtype))
        u = xt @ params["up"][ei].to(compute_dtype)
        o = (g * u) @ params["down"][ei].to(compute_dtype)
        w = torch.where(expert_idx == ei, gate_vals, 0.0).sum(dim=-1)
        y = y + o * w.to(compute_dtype)[:, None]
    return y.reshape(b, s, d)
