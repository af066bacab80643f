"""Meshes for the production deployment, tests and runs across ranks.

Counterpart of the JAX package's ``launch/mesh.py``. Two kinds of mesh:

* ``Mesh`` — a host-side description, axis names and sizes, touching no
  device. The one-card paths take it: all m agents are stacked on dim 0
  of every parameter leaf, and the mesh only says how many agents a
  layout implies (``num_agents``) and over which axes (``agent_axes``).
* ``init_mesh(shape, axes, device)`` — a ``torch.distributed``
  ``DeviceMesh`` over the default process group, one rank a device (NCCL
  on CUDA, gloo on the CPU). The launcher's mesh paths take it: each rank
  holds one agent (or, under ``data_dp``, one replica of an agent along
  ``model``), and the gossip crosses ranks by point-to-point exchanges
  (``core/gossip.py``).

``axis_sizes`` reads either kind as ``{axis name: size}`` (the reference's
``mesh.shape[name]``); ``coordinate``, ``agent_index``, ``axis_ranks``,
``axis_group`` and ``all_gather`` read a ``DeviceMesh`` for the calling
rank.
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
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout: datetime.timedelta | None = None,
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, ranks laid out row-major.

    ``device=None`` means CUDA over NCCL and raises
    ``compat.NoCudaDeviceError`` without a card (rank r takes card r mod
    the cards on its host); ``device="cpu"`` means gloo. The default group
    is initialised here unless it already is: from ``init_method`` (a
    ``file://`` or ``tcp://`` address) with ``rank`` and ``world_size``,
    or, without them, from the usual ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE`` environment variables.
    """
    dev = compat.resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
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
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))


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


def all_gather(x: torch.Tensor, mesh: DeviceMesh,
               axes: tuple[str, ...]) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axes`` (through the calling rank's other
    coordinates), in ``agent_index`` order; collective over the group."""
    ranks = axis_ranks(mesh, axes)
    parts = [torch.empty_like(x) for _ in ranks]
    dist.all_gather(parts, x.contiguous(), group=axis_group(mesh, axes))
    order = sorted(ranks)     # a group's ranks ascend
    return [parts[order.index(r)] for r in ranks]
