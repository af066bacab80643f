"""Mesh descriptions for the production deployment and tests.

Counterpart of the JAX package's ``launch/mesh.py``. A ``Mesh`` here is a
host-side description — axis names and sizes — and touches no device: on
one card all m agents are stacked on dim 0 of every parameter leaf, and
the mesh only says how many agents a layout implies (``num_agents``) and
over which axes (``agent_axes``). Placing the ``data``/``model`` axes on
several cards (FSDP over ``data``, tensor parallelism over ``model``, the
agents' gossip by point-to-point exchanges) is the multi-card slice's
work and is not done here.
"""

from __future__ import annotations

import dataclasses


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


def agent_axes(mesh: Mesh, layout: str) -> tuple[str, ...]:
    """Mesh axes whose product forms the D-PSGD agent space."""
    has_pod = "pod" in mesh.axis_names
    if layout in ("data", "data_dp"):
        return ("pod", "data") if has_pod else ("data",)
    if layout == "pod":
        return ("pod",) if has_pod else ()
    raise ValueError(f"unknown agent layout {layout!r}")


def num_agents(mesh: Mesh, layout: str) -> int:
    n = 1
    for a in agent_axes(mesh, layout):
        n *= mesh.shape[a]
    return max(n, 1)
