"""Meshes for the production deployment, tests and runs across ranks.

Counterpart of the JAX package's ``launch/mesh.py``. Two kinds of mesh:

* ``Mesh`` — a host-side description, axis names and sizes, touching no
  device. The one-card paths take it: all m agents are stacked on dim 0
  of every parameter leaf, and the mesh only says how many agents a
  layout implies (``num_agents``) and over which axes (``agent_axes``).
* ``init_mesh(shape, axes, device, backend=)`` — a ``torch.distributed``
  ``DeviceMesh`` over the default process group (NCCL on CUDA, gloo on the
  CPU, unless ``backend`` says otherwise). The launcher's mesh paths take
  it: each rank holds one agent (or, under ``data_dp``, one replica of an
  agent along ``model``), or its ``model`` part of one agent's leaves, and
  the gossip crosses ranks by point-to-point exchanges
  (``core/gossip.py``).

``axis_sizes`` reads either kind as ``{axis name: size}`` (the reference's
``mesh.shape[name]``); ``coordinate``, ``agent_index``, ``axis_ranks``,
``axis_group``, ``all_gather``, ``all_reduce``, ``reduce_scatter`` and
``all_to_all`` read a ``DeviceMesh`` for the calling rank; ``group_all_reduce``, ``all_gather_into`` and
``exchange`` act on a process group.

Gloo moves host memory. Where a group's backend is gloo and a tensor lies
on CUDA, the collectives here stage it through pinned host memory: that
is the transport the caller chose with ``backend="gloo"`` (several ranks
sharing one card, which NCCL refuses), not a fallback.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import compat


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(
                f"{len(self.axis_names)} axis names for "
                f"{len(self.axis_sizes)} sizes"
            )

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single-pod (256 chips) or 2×16×16 two-pod (512 chips) mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """Small mesh for tests (one card holds all of it)."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def init_mesh(
    shape,
    axes,
    device: str | torch.device | None = None,
    *,
    backend: str | None = None,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout: datetime.timedelta | None = None,
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, ranks laid out row-major.

    ``device=None`` means CUDA and raises ``compat.NoCudaDeviceError``
    without a card (rank r takes card r mod the cards on its host);
    ``device="cpu"`` means the CPU. ``backend`` defaults to NCCL on CUDA
    and gloo on the CPU; ``backend="gloo"`` on CUDA lets several ranks
    share one card, their collectives staged through host memory. The
    default group is initialised here unless it already is (then its
    backend must be ``backend``): from ``init_method`` (a ``file://`` or
    ``tcp://`` address) with ``rank`` and ``world_size``, or, without
    them, from the usual ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE`` environment variables.
    """
    dev = compat.resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo") or (backend == "nccl"
                                           and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev.type}")
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(
            f"the default group runs {dist.get_backend()}, not {backend}")
    if not dist.is_initialized():
        kwargs = {} if timeout is None else {"timeout": timeout}
        if init_method is not None:
            kwargs.update(init_method=init_method, rank=rank,
                          world_size=world_size)
        dist.init_process_group(backend, **kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(
            f"mesh {shape} needs {int(np.prod(shape))} ranks, the group "
            f"has {dist.get_world_size()}")
    ranks = torch.arange(dist.get_world_size()).reshape(shape)
    # The mesh's device type is its groups' transport: gloo's is the host.
    kind = "cuda" if backend == "nccl" else "cpu"
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(axes))


def axis_names(mesh: Mesh | DeviceMesh) -> tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh: Mesh | DeviceMesh) -> dict[str, int]:
    """``{axis name: size}`` of either kind of mesh."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return mesh.shape


def agent_axes(mesh: Mesh | DeviceMesh, layout: str) -> tuple[str, ...]:
    """Mesh axes whose product forms the D-PSGD agent space."""
    has_pod = "pod" in axis_names(mesh)
    if layout in ("data", "data_dp"):
        return ("pod", "data") if has_pod else ("data",)
    if layout == "pod":
        return ("pod",) if has_pod else ()
    raise ValueError(f"unknown agent layout {layout!r}")


def num_agents(mesh: Mesh | DeviceMesh, layout: str) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in agent_axes(mesh, layout):
        n *= sizes[a]
    return max(n, 1)


def coordinate(mesh: DeviceMesh) -> dict[str, int]:
    """The calling rank's ``{axis name: index}`` on ``mesh``."""
    coords = mesh.get_coordinate()
    if coords is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, coords))


def agent_index(mesh: Mesh | DeviceMesh, axes: tuple[str, ...],
                coords: dict[str, int] | None = None) -> int:
    """The row-major index over ``axes`` of ``coords`` (the calling rank's
    on a ``DeviceMesh`` when None): the reference's agent id."""
    coords = coordinate(mesh) if coords is None else coords
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def axis_ranks(mesh: DeviceMesh, axes: tuple[str, ...],
               coords: dict[str, int] | None = None) -> list[int]:
    """Global ranks along ``axes`` through ``coords`` (the calling rank's
    when None), in ``agent_index`` order: entry i is the rank whose index
    over ``axes`` is i and whose coordinates on the other axes are
    ``coords``'."""
    coords = coordinate(mesh) if coords is None else coords
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh.permute(
        [names.index(a) for a in axes]
        + [i for i, a in enumerate(names) if a not in axes])
    rest = tuple(coords[a] for a in names if a not in axes)
    return [int(r) for r in grid[(Ellipsis, *rest)].reshape(-1)]


_GROUPS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def axis_group(mesh: DeviceMesh, axes: tuple[str, ...]):
    """The process group over ``axes`` through the calling rank's
    coordinates on the other axes. One axis is the ``DeviceMesh``'s own
    group; for several, every rank builds the groups of every fixed
    coordinate of the other axes with ``dist.new_group``, in one order,
    once per mesh (the first call is collective: every rank makes it)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    known = _GROUPS.setdefault(mesh, {})
    if axes not in known:
        sizes = axis_sizes(mesh)
        others = [a for a in mesh.mesh_dim_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            ranks = axis_ranks(mesh, axes, dict(zip(others, fixed)))
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
        known[axes] = mine
    return known[axes]


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through pinned host memory: a CUDA
    tensor over a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)


def group_all_reduce(x: torch.Tensor, group,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced (sum by default) over ``group`` (None: the default
    group), in place; returns ``x``. Collective over the group."""
    if not _staged(x, group):
        dist.all_reduce(x, op=op, group=group)
        return x
    host = _host(x)
    dist.all_reduce(host, op=op, group=group)
    return x.copy_(host)


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axes: tuple[str, ...],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over the ranks along ``axes``
    through the calling rank's other coordinates, in place; returns
    ``x``. Collective over the group."""
    return group_all_reduce(x, axis_group(mesh, axes), op)


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``dist.all_gather_into_tensor`` over ``group``, staged for gloo."""
    if not _staged(x, group):
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    dist.all_gather_into_tensor(host, _host(x.contiguous()), group=group)
    out.copy_(host)


def exchange(messages: list, group) -> None:
    """Point-to-point messages in one ``batch_isend_irecv`` over
    ``group``, posted in the order given: each is ``("send", tensor,
    global rank)`` or ``("recv", buffer, global rank)``, the buffer filled
    in place; returns when all are done. Both ends must post the messages
    between them in one order."""
    if not messages:
        return
    staged = _staged(messages[0][1], group)
    wire = [
        (_host(t) if kind == "send" else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True)) if staged else t
        for kind, t, _ in messages
    ]
    ops = [dist.P2POp(dist.isend if kind == "send" else dist.irecv, w,
                      peer, group)
           for (kind, _, peer), w in zip(messages, wire)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (kind, buf, _), host in zip(messages, wire):
            if kind == "recv":
                buf.copy_(host)


def all_gather(x: torch.Tensor, mesh: DeviceMesh,
               axes: tuple[str, ...]) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axes`` (through the calling rank's other
    coordinates), in ``agent_index`` order; collective over the group."""
    ranks = axis_ranks(mesh, axes)
    group = axis_group(mesh, axes)
    order = sorted(ranks)     # a group's ranks ascend
    if _staged(x, group):
        parts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                 for _ in ranks]
        dist.all_gather(parts, _host(x.contiguous()), group=group)
        return [parts[order.index(r)].to(x.device) for r in ranks]
    parts = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x.contiguous(), group=group)
    return [parts[order.index(r)] for r in ranks]


def _group_order(mesh: DeviceMesh, axes: tuple[str, ...]):
    """(the group over ``axes``, the position in ``agent_index`` order of
    each of its ranks in group order: a group's ranks ascend)."""
    ranks = axis_ranks(mesh, axes)
    return axis_group(mesh, axes), [ranks.index(r) for r in sorted(ranks)]


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, axes: tuple[str, ...],
                   dim: int) -> torch.Tensor:
    """The calling rank's part along ``dim`` of ``x`` summed over the ranks
    along ``axes``: ``x`` is cut into as many equal parts along ``dim`` as
    the group has ranks, and the rank at index i over ``axes`` gets the
    sum of every rank's part i (``dist.reduce_scatter_tensor``);
    collective over the group."""
    group, order = _group_order(mesh, axes)
    n = len(order)
    if x.shape[dim] % n:
        raise ValueError(f"dim of {x.shape[dim]} over {n} ranks")
    parts = x.movedim(dim, 0).chunk(n)
    wire = torch.cat([parts[i] for i in order]).contiguous()
    out = torch.empty(parts[0].shape, dtype=x.dtype, device=x.device)
    if _staged(x, group):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(host, _host(wire), group=group)
        out.copy_(host)
    else:
        dist.reduce_scatter_tensor(out, wire, group=group)
    return out.movedim(0, dim).contiguous()


def all_to_all(parts: list, mesh: DeviceMesh,
               axes: tuple[str, ...]) -> list[torch.Tensor]:
    """``parts[i]`` sent to the rank at index i over ``axes``; returns what
    each rank sent this one, in ``agent_index`` order. The parts have one
    shape and dtype (``dist.all_to_all_single`` on their stack: gloo
    carries no list form); collective over the group."""
    group, order = _group_order(mesh, axes)
    if len(parts) != len(order):
        raise ValueError(f"{len(parts)} parts for {len(order)} ranks")
    wire = torch.stack([parts[i] for i in order])
    if _staged(wire, group):
        host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
        dist.all_to_all_single(host, _host(wire), group=group)
        got = host.to(wire.device)
    else:
        got = torch.empty_like(wire)
        dist.all_to_all_single(got, wire, group=group)
    out: list = [None] * len(order)
    for j, i in enumerate(order):
        out[i] = got[j]
    return out
