"""Runtime CSR contracts for the incidence structures.

The port's own copy of the JAX package's ``analysis/contracts.py``: the
validators ``net/`` calls, behind the same ``REPRO_VALIDATE`` switch
(``contracts_static`` checks statically that each class registered in
``VALIDATORS`` calls ``maybe_validate`` from its ``__post_init__``).

The vectorized engines trust their precompiled CSR payloads blindly:
a non-monotone ``link_ptr`` silently mis-slices, an out-of-bounds
entry index reads another link's categories, a float32 capacity array
perturbs every priced makespan. These invariants are declared here
once and validated at construction of ``BranchIncidence``
(``net/simulator.py``), ``CategoryIncidence`` and ``_FlatCategories``
(``net/categories.py``) whenever ``REPRO_VALIDATE=1`` — the safety net
incremental incidence patching (ROADMAP item 3) will run behind.

Validation is opt-in because construction sits on hot paths (one
incidence per routing solution, one rescale per capacity phase): with
the flag unset the cost is one environment lookup and a dict probe.
The nightly tier-1 suite runs with it enabled; tests can monkeypatch
``REPRO_VALIDATE``.

This module is imported by ``repro_torch.net`` at module load, so it must
not import anything from ``repro_torch`` outside this package. Dispatch is
by class *name* (``maybe_validate``) for the same reason: the
dataclasses call in, never the other way around.
"""

from __future__ import annotations

import os

import numpy as np

_ENV_FLAG = "REPRO_VALIDATE"


class ContractViolation(ValueError):
    """A CSR incidence structure failed a declared invariant.

    ``structure``/``field``/``invariant`` name the violation precisely;
    the message says what was found and what well-formed looks like, so
    the error is actionable at the (possibly distant) construction site
    that produced the corrupt payload.
    """

    def __init__(self, structure: str, field: str, invariant: str,
                 detail: str):
        self.structure = structure
        self.field = field
        self.invariant = invariant
        super().__init__(
            f"{structure}.{field} violates '{invariant}': {detail}"
        )


def validation_enabled() -> bool:
    """True when ``REPRO_VALIDATE`` is set to anything but ''/'0'."""
    return os.environ.get(_ENV_FLAG, "") not in ("", "0")


# ---------------------------------------------------------------------------
# Invariant primitives — each raises ContractViolation with a named
# invariant and an actionable message.
# ---------------------------------------------------------------------------


def _check_dtype(structure: str, field: str, arr: np.ndarray,
                 expected: type) -> None:
    if not isinstance(arr, np.ndarray):
        raise ContractViolation(
            structure, field, "is-ndarray",
            f"got {type(arr).__name__}; build it with np.asarray(..., "
            f"dtype=np.{np.dtype(expected).name})",
        )
    if arr.dtype != np.dtype(expected):
        raise ContractViolation(
            structure, field, "dtype",
            f"got {arr.dtype}, expected {np.dtype(expected).name} — "
            "pricing arrays are float64 and index arrays int64 "
            "everywhere; cast at the producer, "
            "not the consumer",
        )


def _check_length(structure: str, field: str, arr: np.ndarray,
                  expected: int, what: str) -> None:
    if arr.ndim != 1 or arr.shape[0] != expected:
        raise ContractViolation(
            structure, field, "length",
            f"shape {arr.shape}, expected ({expected},) — must have one "
            f"entry per {what}",
        )


def _check_ptr(structure: str, field: str, ptr: np.ndarray,
               num_rows: int, nnz: int) -> None:
    """CSR pointer: int64, [num_rows+1], starts 0, ends nnz, monotone."""
    _check_dtype(structure, field, ptr, np.int64)
    _check_length(structure, field, ptr, num_rows + 1, "row plus sentinel")
    if ptr.size and (ptr[0] != 0 or ptr[-1] != nnz):
        raise ContractViolation(
            structure, field, "ptr-bounds",
            f"ptr[0]={ptr[0]}, ptr[-1]={ptr[-1]}, expected 0 and nnz="
            f"{nnz} — the pointer must span exactly the entry arrays",
        )
    if ptr.size and np.any(np.diff(ptr) < 0):
        bad = int(np.argmax(np.diff(ptr) < 0))
        raise ContractViolation(
            structure, field, "ptr-monotone",
            f"decreases at row {bad} ({ptr[bad]} -> {ptr[bad + 1]}) — "
            "CSR pointers are cumulative counts and must be "
            "non-decreasing; rebuild via bincount+cumsum",
        )


def _check_index(structure: str, field: str, idx: np.ndarray,
                 upper: int, what: str) -> None:
    """Index array: int64 and within [0, upper)."""
    _check_dtype(structure, field, idx, np.int64)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= upper):
        raise ContractViolation(
            structure, field, "index-bounds",
            f"values span [{idx.min()}, {idx.max()}], must lie in "
            f"[0, {upper}) — every entry must name a real {what}",
        )


def _check_finite_positive(structure: str, field: str,
                           arr: np.ndarray) -> None:
    if arr.size and not np.all(np.isfinite(arr) & (arr > 0)):
        raise ContractViolation(
            structure, field, "finite-positive",
            "contains non-finite or non-positive values — capacities "
            "and coefficients are strictly positive bytes/s quantities",
        )


def _check_ptr_matches_entries(structure: str, ptr_field: str,
                               ptr: np.ndarray, entry_field: str,
                               entries: np.ndarray) -> None:
    """Each CSR slice [ptr[r], ptr[r+1]) must hold entries with row id
    r — i.e. ptr is exactly the bincount+cumsum of the (sorted) row
    array. Catches ptr/entry mismatches that in-bounds checks miss."""
    expect = np.repeat(
        np.arange(ptr.size - 1, dtype=np.int64), np.diff(ptr)
    )
    if not np.array_equal(expect, entries):
        bad = int(np.argmax(expect != entries))
        raise ContractViolation(
            structure, ptr_field, "ptr-entry-consistency",
            f"slice arithmetic puts entry {bad} in row {expect[bad]} "
            f"but {entry_field}[{bad}]={entries[bad]} — the entry array "
            "must be row-major-sorted with ptr its cumulative histogram",
        )


# ---------------------------------------------------------------------------
# Per-structure validators (duck-typed: attribute access only, so this
# module never imports repro_torch.net).
# ---------------------------------------------------------------------------


def validate_branch_incidence(inc) -> None:
    """All declared invariants of ``net.simulator.BranchIncidence``."""
    s = "BranchIncidence"
    nb = inc.flows.shape[0] if hasattr(inc.flows, "shape") else 0
    _check_dtype(s, "base_capacity", inc.base_capacity, np.float64)
    _check_finite_positive(s, "base_capacity", inc.base_capacity)
    ne = inc.base_capacity.shape[0]
    _check_dtype(s, "flows", inc.flows, np.int64)
    _check_dtype(s, "links", inc.links, np.int64)
    if inc.links.shape != (nb, 2):
        raise ContractViolation(
            s, "links", "length",
            f"shape {inc.links.shape}, expected ({nb}, 2) — one (i, j) "
            "overlay endpoint pair per branch",
        )
    nnz = inc.flat_branch.shape[0]
    _check_index(s, "flat_branch", inc.flat_branch, nb, "branch")
    _check_length(s, "flat_edge", inc.flat_edge, nnz, "traversal entry")
    _check_index(s, "flat_edge", inc.flat_edge, ne, "indexed edge")
    _check_ptr(s, "branch_ptr", inc.branch_ptr, nb, nnz)
    _check_ptr_matches_entries(
        s, "branch_ptr", inc.branch_ptr, "flat_branch", inc.flat_branch
    )
    _check_length(s, "edge_branch", inc.edge_branch, nnz, "traversal entry")
    _check_index(s, "edge_branch", inc.edge_branch, nb, "branch")
    _check_ptr(s, "edge_ptr", inc.edge_ptr, ne, nnz)
    if len(inc.edges) != ne or len(inc.edge_index) != ne:
        raise ContractViolation(
            s, "edges", "length",
            f"{len(inc.edges)} edges / {len(inc.edge_index)} index "
            f"entries for {ne} capacities — the three must agree",
        )


def _check_bucket(structure: str, field: str, padded: int,
                  real: int) -> None:
    """Padded axis: power-of-two bucket >= 8 with >= 1 pad slot."""
    if padded < 8 or padded & (padded - 1) or padded <= real:
        raise ContractViolation(
            structure, field, "padded-bucket",
            f"padded extent {padded} for real extent {real} — device "
            "axes are power-of-two buckets >= 8 with at least one "
            "padding slot (the inert row every pad entry points at); "
            "rebuild via torch_engine.device_incidence",
        )


def _check_pad_value(structure: str, field: str, arr: np.ndarray,
                     start: int, value) -> None:
    if arr[start:].size and not np.all(arr[start:] == value):
        raise ContractViolation(
            structure, field, "inert-padding",
            f"padding tail [{start}:] must be uniformly {value!r} so "
            "padded entries/rows cannot perturb segment reductions — "
            f"found {arr[start:][arr[start:] != value][:3]!r}",
        )


def _check_prefix(structure: str, field: str, arr: np.ndarray,
                  expect: np.ndarray) -> None:
    n = expect.shape[0]
    if not np.array_equal(arr[:n], expect):
        bad = int(np.argmax(arr[:n] != expect))
        raise ContractViolation(
            structure, field, "source-prefix",
            f"entry {bad} is {arr[bad]!r} but the source incidence has "
            f"{expect[bad]!r} — the real prefix must be bitwise-equal "
            "to the BranchIncidence payload (padding never rewrites "
            "live entries)",
        )


def validate_device_incidence(dev) -> None:
    """All declared invariants of ``net.torch_engine.DeviceIncidence``.

    The padded device layout is only safe if (a) every real prefix is
    bitwise the source ``BranchIncidence`` payload, (b) every padding
    entry points at the dedicated inert row (branch ``B`` with size 0,
    edge ``E`` with capacity 1), (c) the edge-major ordering is
    sorted so ``segment_sum(..., indices_are_sorted=True)`` is valid,
    and (d) the bounded-degree tables the kernel actually gathers
    through (``branch_table``/``edge_table``) repack the CSR segments
    exactly, padded with the inert row id.
    """
    s = "DeviceIncidence"
    src = dev.source
    validate_branch_incidence(src)
    nb, ne = src.flows.shape[0], src.base_capacity.shape[0]
    nnz = src.flat_branch.shape[0]
    if (dev.num_branches, dev.num_edges, dev.num_entries) != (nb, ne, nnz):
        raise ContractViolation(
            s, "num_branches", "source-extents",
            f"declared (B, E, nnz)=({dev.num_branches}, {dev.num_edges},"
            f" {dev.num_entries}) but source has ({nb}, {ne}, {nnz}) — "
            "the unpadded extents are what run_rollouts slices back out",
        )
    zp = dev.flat_branch.shape[0]
    for field in ("flat_branch", "flat_edge", "edge_branch", "edge_edge"):
        arr = getattr(dev, field)
        _check_dtype(s, field, arr, np.int64)
        _check_length(s, field, arr, zp, "padded traversal entry")
    _check_dtype(s, "base_capacity", dev.base_capacity, np.float64)
    _check_dtype(s, "sizes", dev.sizes, np.float64)
    _check_bucket(s, "flat_branch", zp, nnz)
    _check_bucket(s, "base_capacity", dev.base_capacity.shape[0], ne)
    _check_bucket(s, "sizes", dev.sizes.shape[0], nb)
    _check_prefix(s, "flat_branch", dev.flat_branch, src.flat_branch)
    _check_prefix(s, "flat_edge", dev.flat_edge, src.flat_edge)
    _check_prefix(s, "edge_branch", dev.edge_branch, src.edge_branch)
    _check_prefix(
        s, "edge_edge", dev.edge_edge,
        np.repeat(np.arange(ne, dtype=np.int64), np.diff(src.edge_ptr)),
    )
    _check_prefix(s, "base_capacity", dev.base_capacity,
                  src.base_capacity)
    _check_pad_value(s, "flat_branch", dev.flat_branch, nnz, nb)
    _check_pad_value(s, "flat_edge", dev.flat_edge, nnz, ne)
    _check_pad_value(s, "edge_branch", dev.edge_branch, nnz, nb)
    _check_pad_value(s, "edge_edge", dev.edge_edge, nnz, ne)
    _check_pad_value(s, "base_capacity", dev.base_capacity, ne, 1.0)
    _check_pad_value(s, "sizes", dev.sizes, nb, 0.0)
    for field, rows, real_ptr in (
        ("branch_ptr", dev.sizes.shape[0], src.branch_ptr),
        ("edge_ptr", dev.base_capacity.shape[0], src.edge_ptr),
    ):
        ptr = getattr(dev, field)
        real = real_ptr.shape[0] - 1
        _check_dtype(s, field, ptr, np.int64)
        _check_length(s, field, ptr, rows + 1, "padded CSR pointer")
        _check_prefix(s, field, ptr, real_ptr)
        # Pad row `real` owns exactly the pad entries [nnz, zp); rows
        # past it are empty — that closure is what makes the cumsum
        # segment reduction equal an element-wise segment sum.
        _check_pad_value(s, field, ptr, real + 1, zp)
    for field, real_ptr, values, rows, fill in (
        ("branch_table", src.branch_ptr, src.flat_edge,
         dev.sizes.shape[0], ne),
        ("edge_table", src.edge_ptr, src.edge_branch,
         dev.base_capacity.shape[0], nb),
    ):
        table = getattr(dev, field)
        _check_dtype(s, field, table, np.int32)
        deg = np.diff(real_ptr)
        width = max(2, 1 << max(0, int(deg.max(initial=0)) - 1).bit_length())
        if table.shape != (rows, width):
            raise ContractViolation(
                s, field, "table-shape",
                f"shape {table.shape} != ({rows}, {width}) — bounded-"
                "degree tables span every padded row at the power-of-"
                "two width of the maximum real degree",
            )
        expected = np.full((rows, width), fill, dtype=np.int32)
        mask = np.arange(width)[None, :] < deg[:, None]
        expected[: deg.size][mask] = values
        if not np.array_equal(table, expected):
            bad = int(np.argmax(np.any(table != expected, axis=1)))
            raise ContractViolation(
                s, field, "table-packing",
                f"row {bad} does not repack its CSR segment — each row "
                "must list the segment's ids in order, padded with the "
                f"inert id {fill}; the kernel gathers through these "
                "rows instead of the CSR entries",
            )
    if nnz > 1 and np.any(np.diff(dev.edge_edge[:nnz]) < 0):
        bad = int(np.argmax(np.diff(dev.edge_edge[:nnz]) < 0))
        raise ContractViolation(
            s, "edge_edge", "entries-sorted",
            f"edge ids decrease at entry {bad} — the edge-major "
            "ordering must be ascending, it is what licenses the "
            "cumsum-based sorted-segment reduction on the device",
        )
    if dev.sizes.size and not np.all(
        np.isfinite(dev.sizes) & (dev.sizes >= 0)
    ):
        raise ContractViolation(
            s, "sizes", "finite-nonnegative",
            "per-branch demand sizes must be finite and nonnegative "
            "byte counts (padding rows are exactly 0)",
        )


def validate_category_incidence(inc) -> None:
    """All declared invariants of ``net.categories.CategoryIncidence``."""
    s = "CategoryIncidence"
    m, nf = inc.num_agents, inc.capacity.shape[0]
    if not (np.isfinite(inc.kappa) and inc.kappa > 0):
        raise ContractViolation(
            s, "kappa", "finite-positive",
            f"kappa={inc.kappa!r} — per-link traffic must be a positive "
            "byte count",
        )
    _check_dtype(s, "capacity", inc.capacity, np.float64)
    _check_finite_positive(s, "capacity", inc.capacity)
    nnz = inc.entry_link.shape[0]
    _check_index(s, "entry_link", inc.entry_link, m * m, "dense link id")
    _check_length(s, "entry_cat", inc.entry_cat, nnz, "entry")
    _check_index(s, "entry_cat", inc.entry_cat, nf, "category")
    _check_dtype(s, "entry_coef", inc.entry_coef, np.float64)
    _check_length(s, "entry_coef", inc.entry_coef, nnz, "entry")
    _check_finite_positive(s, "entry_coef", inc.entry_coef)
    _check_ptr(s, "link_ptr", inc.link_ptr, m * m, nnz)
    _check_ptr_matches_entries(
        s, "link_ptr", inc.link_ptr, "entry_link", inc.entry_link
    )
    if nnz and not np.array_equal(
        inc.entry_coef, (inc.kappa / inc.capacity)[inc.entry_cat]
    ):
        raise ContractViolation(
            s, "entry_coef", "coef-consistency",
            "entry_coef != (kappa / capacity)[entry_cat] bitwise — "
            "coefficients must be rebuilt (never patched in place) "
            "whenever capacity changes; see CategoryIncidence.rescaled",
        )


def validate_flat_categories(flat) -> None:
    """All declared invariants of ``net.categories._FlatCategories``."""
    s = "_FlatCategories"
    m, nf = flat.num_agents, flat.num_categories
    nnz = flat.entry_link.shape[0]
    _check_index(s, "entry_link", flat.entry_link, m * m, "dense link id")
    _check_length(s, "entry_cat", flat.entry_cat, nnz, "entry")
    _check_index(s, "entry_cat", flat.entry_cat, nf, "category")
    _check_ptr(s, "link_ptr", flat.link_ptr, m * m, nnz)
    _check_ptr_matches_entries(
        s, "link_ptr", flat.link_ptr, "entry_link", flat.entry_link
    )
    if nnz > 1:
        dl = np.diff(flat.entry_link)
        dc = np.diff(flat.entry_cat)
        if not np.all((dl > 0) | ((dl == 0) & (dc > 0))):
            bad = int(np.argmax(~((dl > 0) | ((dl == 0) & (dc > 0)))))
            raise ContractViolation(
                s, "entry_link", "entries-sorted",
                f"entries {bad} and {bad + 1} are not strictly "
                "(link, category)-ascending — the payload must be the "
                "fused-key sort compute_categories produces (each "
                "(link, family) pair at most once)",
            )


# Dispatch by class name: the dataclasses call ``maybe_validate(self)``
# from ``__post_init__``; this module never imports their definitions.
VALIDATORS = {
    "BranchIncidence": validate_branch_incidence,
    "CategoryIncidence": validate_category_incidence,
    "DeviceIncidence": validate_device_incidence,
    "_FlatCategories": validate_flat_categories,
}


def maybe_validate(obj) -> None:
    """Validate ``obj`` against its registered contract when
    ``REPRO_VALIDATE`` is on; free (one env read) otherwise."""
    if validation_enabled():
        validator = VALIDATORS.get(type(obj).__name__)
        if validator is not None:
            validator(obj)
