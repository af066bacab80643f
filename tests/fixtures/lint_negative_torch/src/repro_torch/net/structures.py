"""Planted contract violation: CategoryIncidence without the
``maybe_validate`` hook; DeviceIncidence, which the port's contracts
register, is not defined at all."""

import dataclasses


def maybe_validate(obj):
    return obj


@dataclasses.dataclass(frozen=True)
class BranchIncidence:
    size: int

    def __post_init__(self):
        maybe_validate(self)


@dataclasses.dataclass(frozen=True)
class CategoryIncidence:  # planted: missing-contract-hook
    size: int


@dataclasses.dataclass(frozen=True)
class _FlatCategories:
    size: int

    def __post_init__(self):
        maybe_validate(self)
