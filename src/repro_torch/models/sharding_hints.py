"""Opt-in activation sharding hints and the tensor-parallel context.

Counterpart of the JAX package's ``models/sharding_hints.py``. The
launch layer knows the mesh ("data"/"model"/"pod" axes); the model only
knows logical roles ("batch", "seq", "tp"). ``hints`` installs a
role→axes map, and the mesh when there is one, for the duration of a
``with`` block; ``constrain(x, roles)`` is called where the reference
pins activations (the group boundary in ``model.py``, the dispatch
buffers in ``moe.py``). The port's activations are local tensors, with no
partitioner to pin them, so ``constrain`` returns ``x`` itself with or
without hints. ``resolve(shape, roles, mesh)`` gives the spec that the
reference's divisibility guard would pin under the installed hints.

Tensor parallelism inside an agent. When the installed hints come with a
``DeviceMesh`` whose "tp" axes have a size T > 1, ``tp()`` is that
context (mesh, axes, T, this rank's index) and each rank's
parameter leaves are its parts under the sharding rules
(``launch/sharding.py``). The model code then runs on the local widths it
reads from the leaves, with Megatron's conjugate pair around each split:

* ``copy_to_tp`` — identity forward, all-reduce backward: in front of a
  column-split projection (and on any replicated tensor that enters a
  rank's partial computation, so its gradient is summed over the ranks);
* ``reduce_from_tp`` — all-reduce forward, identity backward: after a
  row-split projection. (``torch.distributed.nn.functional.all_reduce``
  is not this: its backward sums again, counting the replicated gradient
  T times.)
* ``gather_from_tp`` — all-gather forward along a dim, the rank's part of
  the gradient backward: a split leaf or activation needed whole.

Where a leaf's split along "model" is one the local computation cannot
use as it lies, the rank gathers the leaf whole at its use and slices
what it needs (``take``); GSPMD reshards such leaves silently.
``GATHERED_LEAVES`` names every such leaf, and ``gather_count`` counts
the gathers. Without hints (or at T = 1) every function here returns its
input itself, so the one-card paths run exactly the ops they ran before.

Data parallelism inside an agent. When the installed hints split the
microbatch's rows over "batch" axes, or name "fsdp" / "ep" axes (the
``pod`` layout and serving's 2-D tensor parallelism: both "data"), of a
size above 1 on a ``DeviceMesh``, ``dp()`` is that context, and with it
``plan``: each parameter leaf's dim split over the FSDP axes (None for a
leaf whole over them, or one split along its experts, which stays with
its owner: expert parallelism). Then

* ``gather_fsdp`` — a subtree's FSDP-split leaves gathered whole over the
  axes at their use (``gather_from_fsdp``: all-gather forward,
  reduce-scatter of the gradient backward, so every data rank's
  contribution lands once in each part);
* ``ep_dispatch`` / ``ep_combine`` — the MoE dispatch buffer's expert
  blocks sent to their owners and the experts' outputs sent back
  (all-to-all over the axes, each the other's backward);
* ``batch_mean`` — a detached mean over the batch axes, for a statistic
  of the whole microbatch (the MoE's top-1 share of tokens).

``dp_count`` counts those collectives. Without the context they return
their input itself.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import P
from repro_torch.tree import tree_map

_HINTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "sharding_hints", default=None
)
_TP: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel", default=None
)
_DP: contextvars.ContextVar = contextvars.ContextVar(
    "data_parallel", default=None
)

# Leaves gathered whole at their use under tensor parallelism, and why.
GATHERED_LEAVES = {
    "attention/wq": "query heads split off a head boundary (H % T != 0)",
    "attention/wk": "KV heads that do not match the rank's query heads "
                    "(KV % T != 0, or heads split off a boundary)",
    "attention/wv": "as attention/wk",
    "mamba/in_proj": "a contiguous column split cuts across [u | z]",
    "frontend/patch_proj": "a column split with no row-split partner",
    "slstm/wo": "a row split of the output gate's input projection, which "
                "is concatenated with the three unsplit gates",
}
_GATHERS: collections.Counter = collections.Counter()
# Collectives over the data-parallel axes: "fsdp_gather", "ep_dispatch",
# "ep_combine" (forward calls, the recompute's included).
_DP_CALLS: collections.Counter = collections.Counter()


def gather_count(name: str | None = None) -> int:
    """Leaf gathers since the last reset (of ``name``, or of all)."""
    return sum(_GATHERS.values()) if name is None else _GATHERS[name]


def reset_gather_count() -> None:
    _GATHERS.clear()


def dp_count(name: str | None = None) -> int:
    """Data-parallel collectives since the last reset (of ``name``, or of
    all)."""
    return sum(_DP_CALLS.values()) if name is None else _DP_CALLS[name]


def reset_dp_count() -> None:
    _DP_CALLS.clear()


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The tensor-parallel context: ``size`` ranks along ``axes`` of
    ``mesh``, this rank at ``index``."""
    mesh: DeviceMesh
    axes: tuple[str, ...]
    size: int
    index: int


def _size_of(sizes: dict, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _tensor_parallel(role_axes: dict, mesh) -> TensorParallel | None:
    axes = tuple(role_axes.get("tp", ()))
    if not axes or not isinstance(mesh, DeviceMesh):
        return None
    size = _size_of(mesh_lib.axis_sizes(mesh), axes)
    if size <= 1:
        return None
    return TensorParallel(mesh, axes, size, mesh_lib.agent_index(mesh, axes))


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The data-parallel context: the microbatch's rows split over
    ``batch`` (``batch_size`` ranks), parameters split over ``axes``
    (``size`` ranks, this one at ``index``) as ``plan`` says."""
    mesh: DeviceMesh
    batch: tuple[str, ...]
    batch_size: int
    axes: tuple[str, ...]
    size: int
    index: int
    plan: Any


def _data_parallel(role_axes: dict, mesh, plan) -> DataParallel | None:
    if not isinstance(mesh, DeviceMesh):
        return None
    batch = tuple(role_axes.get("batch", ()))
    # FSDP and EP share their axes ("data"), as in the reference's rules
    axes = tuple(role_axes.get("fsdp") or role_axes.get("ep") or ())
    sizes = mesh_lib.axis_sizes(mesh)
    batch_size, size = _size_of(sizes, batch), _size_of(sizes, axes)
    if batch_size <= 1 and size <= 1:
        return None
    index = mesh_lib.agent_index(mesh, axes) if size > 1 else 0
    return DataParallel(mesh, batch, batch_size, axes, size, index, plan)


class hints:
    """``with hints({"batch": ("data",), "tp": ("model",)}, mesh):``
    installs the role→axes map (and, on a ``DeviceMesh`` whose "tp" axes
    are larger than 1, the tensor-parallel context; where the batch or
    "fsdp" / "ep" axes are, the data-parallel one with ``plan``) until the
    block exits (nested blocks restore the outer map)."""

    def __init__(self, role_axes: dict, mesh=None, plan=None):
        self._role_axes = dict(role_axes)
        self._mesh = mesh
        self._plan = plan
        self._tokens: list = []

    def __enter__(self):
        tp_ctx = _tensor_parallel(self._role_axes, self._mesh)
        dp_ctx = _data_parallel(self._role_axes, self._mesh, self._plan)
        self._tokens.append((_HINTS.set(self._role_axes), _TP.set(tp_ctx),
                             _DP.set(dp_ctx)))
        return self

    def __exit__(self, *exc):
        role_token, tp_token, dp_token = self._tokens.pop()
        _DP.reset(dp_token)
        _TP.reset(tp_token)
        _HINTS.reset(role_token)
        return False


def tp() -> TensorParallel | None:
    """The installed tensor-parallel context, or None (no hints, no mesh,
    or "tp" axes of size 1)."""
    return _TP.get()


def dp() -> DataParallel | None:
    """The installed data-parallel context, or None (no hints, no mesh,
    or batch and "fsdp" / "ep" axes of size 1)."""
    return _DP.get()


def carry(fn):
    """``fn`` with the hints installed now re-installed around each call:
    for a function called later on another thread (the recompute of
    ``torch.utils.checkpoint``, which runs in autograd's device thread on
    CUDA, where this context is not set)."""
    role_axes, ctx, dp_ctx = _HINTS.get(), _TP.get(), _DP.get()
    if role_axes is None:
        return fn

    def run(*args, **kwargs):
        tokens = _HINTS.set(role_axes), _TP.set(ctx), _DP.set(dp_ctx)
        out = fn(*args, **kwargs)
        _DP.reset(tokens[2])
        _TP.reset(tokens[1])
        _HINTS.reset(tokens[0])
        return out

    return run


def constrain(x, roles: tuple):
    """roles: per-dim role name or None, e.g. ("batch", "seq", None).
    The identity on the port's local tensors."""
    return x


def resolve(shape, roles: tuple, mesh) -> P | None:
    """The spec the reference's ``constrain`` pins for a tensor of
    ``shape`` under the installed hints on ``mesh`` (either kind), or
    None when no hints are installed. Divisibility-guarded: a role is
    dropped if its axes' size is 1 or does not divide the dim."""
    mapping = _HINTS.get()
    if mapping is None:
        return None
    sizes = mesh_lib.axis_sizes(mesh)
    spec = []
    for dim, r in enumerate(roles):
        axes = mapping.get(r) if r else None
        if axes:
            size = 1
            for a in axes:
                size *= sizes.get(a, 1)
            if size <= 1 or shape[dim] % size or shape[dim] < size:
                axes = None
        if not axes:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(tuple(axes))
    return P(*spec)


# ---------------------------------------------------------------------------
# The conjugate pair and the gather
# ---------------------------------------------------------------------------


def _reduced(x: torch.Tensor, ctx: TensorParallel, op=dist.ReduceOp.SUM):
    return mesh_lib.all_reduce(
        x.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axes,
        op)


def _gathered(x: torch.Tensor, dim: int, ctx: TensorParallel):
    return mesh_lib.all_gather_cat(x, ctx.mesh, ctx.axes, dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.tp = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, grad):
        return _reduced(grad, fctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return _reduced(x, ctx)

    @staticmethod
    def backward(fctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.tp, fctx.dim, fctx.n = ctx, dim, x.shape[dim]
        return _gathered(x, dim, ctx)

    @staticmethod
    def backward(fctx, grad):
        part = grad.narrow(fctx.dim, fctx.tp.index * fctx.n, fctx.n)
        return part.contiguous(), None, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, sum of the gradient over the TP ranks backward;
    ``x`` itself without a TP context."""
    ctx = tp()
    if ctx is None:
        return x
    return _CopyToTP.apply(x, ctx)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum over the TP ranks forward, identity backward; ``x`` itself
    without a TP context."""
    ctx = tp()
    if ctx is None:
        return x
    return _ReduceFromTP.apply(x, ctx)


def reduce_max_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the TP ranks of a tensor outside autograd
    (a detached stabiliser); ``x`` itself without a TP context."""
    ctx = tp()
    if ctx is None:
        return x
    return _reduced(x.detach(), ctx, dist.ReduceOp.MAX)


def gather_from_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The TP ranks' ``x`` concatenated along ``dim`` in rank order
    forward, this rank's part of the gradient backward; ``x`` itself
    without a TP context."""
    ctx = tp()
    if ctx is None:
        return x
    return _GatherFromTP.apply(x, dim % x.dim(), ctx)


def take(w: torch.Tensor, dim: int, lo: int, hi: int, full: int,
         partial: bool, name: str | None = None) -> torch.Tensor:
    """Columns (or rows) ``[lo, hi)`` of a leaf whose whole size along
    ``dim`` is ``full`` and whose local part is ``w``, for a computation
    that is this rank's partial sum (``partial``) or replicated.

    * The local part is exactly ``[lo, hi)``: ``w`` itself.
    * ``w`` is whole (the rule left it unsplit): its slice; in a partial
      computation through ``copy_to_tp``, so its gradient is summed.
    * Otherwise the leaf is gathered whole (``gather_from_tp``, counted
      under ``name``, a key of ``GATHERED_LEAVES``) and sliced, through
      ``copy_to_tp`` in a partial computation.
    """
    ctx = tp()
    dim = dim % w.dim()
    n = w.shape[dim]
    split = n != full
    if split and ctx.index * n == lo and hi - lo == n:
        return w
    if split:
        if name not in GATHERED_LEAVES:
            raise ValueError(f"{name!r} is not a gathered leaf")
        _GATHERS[name] += 1
        w = gather_from_tp(w, dim)
    if partial:
        w = copy_to_tp(w)
    return w if (lo, hi) == (0, full) else w.narrow(dim, lo, hi - lo)


def local_range(local: int, full: int) -> tuple[int, int, bool]:
    """``(lo, hi, partial)`` of a leaf dim of ``full`` entries whose local
    part has ``local``: this rank's block when the dim is split over the
    TP ranks (a partial computation), else the whole dim."""
    ctx = tp()
    if ctx is None or local == full:
        return 0, full, False
    if local * ctx.size != full:
        raise ValueError(f"a local dim of {local} of {full} over "
                         f"{ctx.size} ranks")
    return ctx.index * local, (ctx.index + 1) * local, True


# ---------------------------------------------------------------------------
# Data parallelism: FSDP's gather, EP's all-to-all, the batch mean
# ---------------------------------------------------------------------------


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch axes' ranks of a tensor outside autograd
    (each rank holds an equal share of the microbatch's rows); ``x``
    itself without a data-parallel context or where the rows are not
    split."""
    ctx = dp()
    if ctx is None or ctx.batch_size <= 1:
        return x
    total = mesh_lib.all_reduce(
        x.detach().clone(memory_format=torch.contiguous_format), ctx.mesh,
        ctx.batch)
    return total / ctx.batch_size


class _GatherFromFSDP(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dp, fctx.dim = ctx, dim
        return mesh_lib.all_gather_cat(x, ctx.mesh, ctx.axes, dim)

    @staticmethod
    def backward(fctx, grad):
        return mesh_lib.reduce_scatter(
            grad.contiguous(), fctx.dp.mesh, fctx.dp.axes, fctx.dim), \
            None, None


def gather_from_fsdp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The FSDP ranks' ``x`` concatenated along ``dim`` forward; backward,
    the gradient summed over those ranks and cut to this rank's part
    (reduce-scatter). ``x`` itself without FSDP axes larger than 1."""
    ctx = dp()
    if ctx is None or ctx.size <= 1:
        return x
    _DP_CALLS["fsdp_gather"] += 1
    return _GatherFromFSDP.apply(x, dim % x.dim(), ctx)


def gather_fsdp(tree, *keys: str, lead: int = 0):
    """``tree`` — the subtree of the parameters at ``keys`` — with each
    leaf that the plan splits over the FSDP axes gathered whole
    (``gather_from_fsdp``); ``lead`` leading dims of the plan's leaves are
    not in ``tree``'s (a group's leaves, unstacked from G). ``tree``
    itself without FSDP."""
    ctx = dp()
    if ctx is None or ctx.size <= 1 or ctx.plan is None:
        return tree
    plan = ctx.plan
    for k in keys:
        plan = plan[k]
    return tree_map(
        lambda leaf, dim: leaf if dim is None
        else gather_from_fsdp(leaf, dim - lead), tree, plan)


class _AllToAll(torch.autograd.Function):
    """``x`` cut along ``split`` into one part per rank, the parts
    exchanged, what came back concatenated along ``cat``; the backward is
    the same with ``split`` and ``cat`` swapped."""

    @staticmethod
    def forward(fctx, x, split, cat, ctx):
        fctx.dp, fctx.split, fctx.cat = ctx, split, cat
        return _exchange(x, split, cat, ctx)

    @staticmethod
    def backward(fctx, grad):
        return _exchange(grad, fctx.cat, fctx.split, fctx.dp), \
            None, None, None


def _exchange(x, split, cat, ctx: DataParallel) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(ctx.size, dim=split)]
    return torch.cat(mesh_lib.all_to_all(parts, ctx.mesh, ctx.axes), dim=cat)


def ep_size(local: int, full: int) -> int:
    """How many ranks share ``full`` experts of which this rank holds
    ``local``: 1 when it holds them all, else the EP axes' size."""
    if local == full:
        return 1
    ctx = dp()
    if ctx is None or local * ctx.size != full:
        raise ValueError(f"{local} of {full} experts on this rank")
    return ctx.size


def ep_dispatch(x: torch.Tensor) -> torch.Tensor:
    """The dispatch buffer ``[b, E, C, D]`` → ``[n·b, E/n, C, D]``: each
    rank's slots of this rank's E/n experts, rows of rank 0 first (n EP
    ranks, rank i owning experts ``[i·E/n, (i+1)·E/n)``)."""
    _DP_CALLS["ep_dispatch"] += 1
    return _AllToAll.apply(x, 1, 0, dp())


def ep_combine(y: torch.Tensor) -> torch.Tensor:
    """The inverse of ``ep_dispatch``: the owners' outputs ``[n·b, E/n, C,
    D]`` → this rank's rows for every expert ``[b, E, C, D]``."""
    _DP_CALLS["ep_combine"] += 1
    return _AllToAll.apply(y, 0, 1, dp())
