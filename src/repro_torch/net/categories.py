"""Underlay-link categories (paper Definition 1) and their inference.

The port's own copy of the JAX package's ``net/categories.py``; it returns
bitwise what the original returns.

A *category* Γ_F, for a set F of overlay links, is the set of underlay
links traversed by **exactly** the overlay links in F. All links in one
category carry identical overlay traffic, so the per-iteration time only
depends on category-level quantities (Lemma III.2):

    τ = max_{F ∈ 𝓕} (κ / C_F) · t_F,   C_F = min_{e ∈ Γ_F} C_e .

We compute categories on **directed** overlay links (the paper's footnote:
capacity constraints are per direction), which generalizes (12) cleanly:
a directed underlay edge (u, v) belongs to the category of the set of
directed overlay links whose routing path traverses (u, v).

Two access paths:
  * ``compute_categories``   — ground truth from full underlay knowledge.
  * ``infer_categories``     — what an uncooperative underlay permits: the
    overlay can consistently estimate (𝓕, C_F) via tomography [17]. We
    model the estimator output (optionally capacity noise); on real
    deployments this would be replaced by the measurement pipeline.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping

import numpy as np

from repro_torch.analysis.contracts import maybe_validate
from repro_torch.net.topology import OverlayNetwork


@dataclasses.dataclass(frozen=True)
class _FlatCategories:
    """Precompiled link×category CSR structure riding along a
    ``Categories`` built by the vectorized ``compute_categories``.

    Exactly the capacity-independent half of a ``CategoryIncidence`` —
    entries sorted by (dense link id ``i·m + j``, family index) with the
    bincount-cumsum ``link_ptr`` — so ``compile_category_incidence``
    only has to assemble the capacity vector and κ/C_F coefficients
    (the ``CategoryIncidence.rescaled`` pattern, applied at compile
    time: structure shared, coefficients rebuilt). Capacity-independent,
    hence ``Categories.scaled`` propagates it unchanged.
    """

    num_agents: int
    num_categories: int
    entry_link: np.ndarray  # [nnz] dense link id i·m + j, link-major
    entry_cat: np.ndarray  # [nnz] family index per entry
    link_ptr: np.ndarray  # [m²+1] CSR slices per link id

    def __post_init__(self):
        # CSR well-formedness contract; no-op unless REPRO_VALIDATE=1
        # (repro_torch.analysis.contracts.validate_flat_categories).
        maybe_validate(self)


@dataclasses.dataclass(frozen=True)
class Categories:
    """Nonempty categories 𝓕 over *directed* overlay links.

    ``members[F]``  — the underlay directed edges in Γ_F (may be empty in
                      inferred mode, where only capacities are known).
    ``capacity[F]`` — bottleneck capacity C_F = min_{e ∈ Γ_F} C_e.
    ``edge_capacity`` — base capacity per member underlay edge (set by
                      ``compute_categories``; None in inferred mode).
                      Needed to re-derive C_F under per-edge capacity
                      scaling, where the bottleneck edge may change.
    Keys F are frozensets of directed overlay links (agent-index pairs).
    """

    members: Mapping[frozenset, tuple[tuple[int, int], ...]]
    capacity: Mapping[frozenset, float]
    edge_capacity: Mapping[tuple[int, int], float] | None = None
    # Private acceleration payload (see _FlatCategories); never part of
    # equality — two Categories with the same mappings are the same
    # categories whether or not one carries the arrays.
    flat: _FlatCategories | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def families(self) -> tuple[frozenset, ...]:
        return tuple(self.capacity.keys())

    def min_capacity(self) -> float:
        """C_min := min_F C_F (Theorem III.5)."""
        return min(self.capacity.values())

    def load_vector(self, link_uses: Mapping[tuple[int, int], int]) -> dict:
        """t_F for a map of directed-overlay-link -> #activated flows (10)."""
        return {
            F: sum(link_uses.get(l, 0) for l in F) for F in self.families
        }

    def completion_time(
        self, link_uses: Mapping[tuple[int, int], int], kappa: float
    ) -> float:
        """Closed-form optimal completion time (Lemma III.2, eq. (11))."""
        t = self.load_vector(link_uses)
        return max(
            (kappa * t[F] / self.capacity[F] for F in self.families),
            default=0.0,
        )

    def scaled(
        self, scale: "float | Mapping[tuple[int, int], float]"
    ) -> "Categories":
        """Categories under phase-scaled capacities (C_F of one
        ``CapacityPhase``).

        Routing paths are capacity-independent, so the family structure
        is unchanged; only C_F moves. A scalar ``scale`` multiplies every
        C_F directly (min commutes with a uniform positive factor) —
        ``scale == 1.0`` returns ``self`` so callers keep object
        identity on the trivial phase. A per-edge Mapping (keyed like
        ``CapacityPhase.scale``, either direction, missing edges 1.0)
        re-derives C_F = min_{e ∈ Γ_F} f_e·C_e from the member edges,
        which requires ground-truth ``members``/``edge_capacity``
        (``compute_categories``; inferred categories raise).
        """
        if not isinstance(scale, Mapping):
            f = float(scale)
            if f <= 0:
                raise ValueError("capacity scale must be positive")
            if f == 1.0:
                return self
            return Categories(
                members=self.members,
                capacity={F: c * f for F, c in self.capacity.items()},
                edge_capacity=(
                    {e: c * f for e, c in self.edge_capacity.items()}
                    if self.edge_capacity is not None else None
                ),
                flat=self.flat,  # family structure is unchanged
            )
        if self.edge_capacity is None or not all(self.members.values()):
            raise ValueError(
                "per-edge capacity scaling needs ground-truth members "
                "and edge capacities (compute_categories); inferred "
                "categories only support scalar scales"
            )

        def factor(e: tuple[int, int]) -> float:
            return float(scale.get(e, scale.get((e[1], e[0]), 1.0)))

        capacity = {
            F: min(self.edge_capacity[e] * factor(e) for e in edges)
            for F, edges in self.members.items()
        }
        if any(c <= 0 for c in capacity.values()):
            raise ValueError("capacity scale must be positive")
        return Categories(
            members=self.members,
            capacity=capacity,
            edge_capacity={
                e: c * factor(e) for e, c in self.edge_capacity.items()
            },
            flat=self.flat,  # family structure is unchanged
        )


@dataclasses.dataclass(frozen=True)
class CategoryIncidence:
    """Precompiled link×category incidence for vectorized engines.

    The analogue of the simulator's ``BranchIncidence``: every directed
    overlay link (i, j) gets the dense id ``i·m + j``; flat-entry arrays
    list, link-major and within each link in ``families`` order (the
    order ``_link_category_costs``-style dict loops would encounter
    them), the categories the link belongs to and their κ/C_F
    coefficients. Compile once per (categories, κ, m); reuse across
    routing calls and design-sweep grid points.
    """

    num_agents: int
    kappa: float
    capacity: np.ndarray  # [nF] C_F in ``families`` order
    entry_link: np.ndarray  # [nnz] dense link id i·m + j, link-major
    entry_cat: np.ndarray  # [nnz] category index per entry
    entry_coef: np.ndarray  # [nnz] κ / C_F per entry
    link_ptr: np.ndarray  # [m²+1] CSR slices into entry_* per link id
    source: "Categories | None" = None  # what this was compiled from

    def __post_init__(self):
        # CSR well-formedness contract; no-op unless REPRO_VALIDATE=1
        # (repro_torch.analysis.contracts.validate_category_incidence).
        # ``rescaled``/``dataclasses.replace`` re-run it, so per-phase
        # recompiles are covered too.
        maybe_validate(self)

    def matches(self, categories: "Categories") -> bool:
        """Cheap fingerprint check that this incidence was compiled from
        ``categories``: object identity (the amortizing call paths pass
        the same object through), else an O(nF) capacity-vector
        comparison. Equal capacities with different memberships would
        slip through the fallback — pass the same object to be exact."""
        if self.source is categories:
            return True
        caps = list(categories.capacity.values())
        return len(caps) == self.num_categories and np.array_equal(
            self.capacity, np.asarray(caps, dtype=np.float64)
        )

    @property
    def num_categories(self) -> int:
        return self.capacity.size

    def link_id(self, i: int, j: int) -> int:
        return i * self.num_agents + j

    def link_categories(self, link_id: int) -> np.ndarray:
        """Category indices of one dense link id (CSR slice)."""
        return self.entry_cat[self.link_ptr[link_id]:self.link_ptr[link_id + 1]]

    def link_costs(self, cat_weights: np.ndarray) -> np.ndarray:
        """Per-link Σ_F (κ/C_F)·w_F as a flat [m²] array.

        ``np.bincount`` accumulates in entry order, so each link's sum is
        added in exactly the per-link order a Python ``sum`` over its
        category list would use — bit-identical costs.
        """
        return np.bincount(
            self.entry_link,
            weights=self.entry_coef * cat_weights[self.entry_cat],
            minlength=self.num_agents * self.num_agents,
        )

    def loads_from_uses(
        self, link_uses: Mapping[tuple[int, int], int]
    ) -> np.ndarray:
        """t_F vector (``Categories.load_vector`` as an array)."""
        loads = np.zeros(self.num_categories)
        for (i, j), n in link_uses.items():
            if n:
                loads[self.link_categories(self.link_id(i, j))] += float(n)
        return loads

    def completion_time(self, loads: np.ndarray) -> float:
        """max_F κ·t_F/C_F — same per-element arithmetic as the
        dict-based ``Categories.completion_time``."""
        if not self.num_categories:
            return 0.0
        return float(np.max(self.kappa * loads / self.capacity))

    def rescaled(self, categories: "Categories") -> "CategoryIncidence":
        """Same link×category structure under phase-scaled capacities.

        ``categories`` must be a capacity-only rescale of the categories
        this incidence was compiled from (``Categories.scaled``): the
        families — and their iteration order — are unchanged, so the
        flat entry arrays are shared and only ``capacity``/``entry_coef``
        are rebuilt. This is how per-phase incidences are compiled once
        per scenario instead of once per (phase, call).
        """
        cap = np.asarray(list(categories.capacity.values()), dtype=np.float64)
        if cap.size != self.num_categories:
            raise ValueError(
                f"rescaled categories have {cap.size} families, "
                f"incidence was compiled for {self.num_categories}"
            )
        coef = self.kappa / cap
        return dataclasses.replace(
            self,
            capacity=cap,
            entry_coef=coef[self.entry_cat] if self.entry_cat.size
            else np.empty(0),
            source=categories,
        )


def _compile_category_incidence_reference(
    categories: Categories, num_agents: int, kappa: float
) -> CategoryIncidence:
    """Per-link Python-append compiler (retained ground truth).

    The original implementation: iterate every family's frozenset,
    append dense link ids, stable-sort by link. The vectorized
    ``compile_category_incidence`` is property-tested bitwise-identical
    to this on the same ``Categories``.
    """
    m = num_agents
    fams = categories.families
    cap = np.array([categories.capacity[F] for F in fams], dtype=np.float64)
    link_ids: list[int] = []
    cat_ids: list[int] = []
    for fi, F in enumerate(fams):
        for (i, j) in F:
            if not (0 <= i < m and 0 <= j < m):
                raise ValueError(
                    f"category link ({i},{j}) out of range for m={m}"
                )
            link_ids.append(i * m + j)
            cat_ids.append(fi)
    link = np.asarray(link_ids, dtype=np.int64)
    cat = np.asarray(cat_ids, dtype=np.int64)
    order = np.argsort(link, kind="stable")
    link, cat = link[order], cat[order]
    coef = kappa / cap
    return CategoryIncidence(
        num_agents=m,
        kappa=kappa,
        capacity=cap,
        entry_link=link,
        entry_cat=cat,
        entry_coef=coef[cat] if cat.size else np.empty(0),
        link_ptr=np.searchsorted(link, np.arange(m * m + 1)),
        source=categories,
    )


def compile_category_incidence(
    categories: Categories, num_agents: int, kappa: float
) -> CategoryIncidence:
    """Build the flat link×category entry arrays for ``categories``.

    Entries are sorted by (dense link id, family index) — exactly the
    order the reference's stable by-link sort of its family-major append
    sequence produces, since each (link, family) pair occurs at most
    once. When ``categories`` carries the ``_FlatCategories`` payload
    (the vectorized ``compute_categories`` output, propagated through
    ``Categories.scaled``), the entry arrays come straight from it with
    no per-link Python; otherwise this falls back to the retained
    reference loop. ``link_ptr`` is a bincount+cumsum CSR pointer —
    identical to (and cheaper than) the reference's O(m² log nnz)
    ``searchsorted`` scan over every dense link id.
    """
    m = num_agents
    fams = categories.families
    flat = categories.flat
    if (
        flat is None
        or flat.num_agents != m
        or flat.num_categories != len(fams)
    ):
        return _compile_category_incidence_reference(
            categories, num_agents, kappa
        )
    cap = np.array([categories.capacity[F] for F in fams], dtype=np.float64)
    cat = flat.entry_cat
    coef = kappa / cap
    return CategoryIncidence(
        num_agents=m,
        kappa=kappa,
        capacity=cap,
        entry_link=flat.entry_link,
        entry_cat=cat,
        entry_coef=coef[cat] if cat.size else np.empty(0),
        link_ptr=flat.link_ptr,
        source=categories,
    )


def _compute_categories_reference(overlay: OverlayNetwork) -> Categories:
    """Dict-of-set grouping (retained ground truth).

    The original per-(link, hop) Python loop. The vectorized
    ``compute_categories`` is property-tested bitwise-identical to this:
    same family keys in the same order, same member-edge order, same
    capacities.
    """
    edge_to_links: dict[tuple[int, int], set] = {}
    for i, j in overlay.directed_overlay_links:
        for e in overlay.path_edges(i, j):
            edge_to_links.setdefault(e, set()).add((i, j))

    members: dict[frozenset, list] = {}
    capacity: dict[frozenset, float] = {}
    edge_capacity: dict[tuple[int, int], float] = {}
    for e, links in edge_to_links.items():
        F = frozenset(links)
        members.setdefault(F, []).append(e)
        c = overlay.underlay.capacity(*e)
        edge_capacity[e] = c
        capacity[F] = min(capacity.get(F, np.inf), c)

    return Categories(
        members={F: tuple(v) for F, v in members.items()},
        capacity=capacity,
        edge_capacity=edge_capacity,
    )


def compute_categories(overlay: OverlayNetwork) -> Categories:
    """Ground-truth categories from full knowledge of the underlay.

    For every directed underlay edge, collect the set of directed overlay
    links routed over it; group edges by that set.

    Vectorized: all (overlay-link, underlay-edge) incidence pairs come
    from one ``OverlayNetwork.batched_path_edges`` call as flat int
    arrays, then ``_group_category_pairs`` groups them per directed edge
    and collapses equal link-set signatures into families — bitwise
    identical to ``_compute_categories_reference`` (property-tested)
    including family-key iteration order. The result carries the
    ``_FlatCategories`` payload that lets ``compile_category_incidence``
    skip its Python loop.
    """
    m = overlay.num_agents
    # The array path encodes node ids into int64 edge codes; anything
    # outside nonnegative machine ints must take the reference path
    # *before* the arrays are built — np.asarray(dtype=int64) would
    # truncate float ids silently and huge ids would overflow
    # ``u · n_nodes + v``, surfacing later as a bogus-edge KeyError (or,
    # worse, a silent collision) instead of an importable error.
    if not all(
        isinstance(n, (int, np.integer)) and 0 <= int(n) <= 2**31 - 1
        for n in overlay.underlay.graph.nodes
    ):
        return _compute_categories_reference(overlay)
    link_arr, eu, ev, rank = overlay.batched_path_edges()
    return _group_category_pairs(
        m, link_arr, eu, ev, rank, overlay.underlay.capacity
    )


def _group_category_pairs(
    m: int,
    link_arr: np.ndarray,
    eu: np.ndarray,
    ev: np.ndarray,
    rank: np.ndarray,
    cap_of,
) -> Categories:
    """Group flat (directed-overlay-link, directed-underlay-edge) pairs
    into ``Categories`` — the vectorized core of ``compute_categories``.

    ``link_arr`` holds dense directed-link ids ``i·(m−1) + j − [j > i]``,
    ``(eu, ev)`` the traversed directed edge per pair, and ``rank`` any
    key whose *order* reproduces the reference's link-major per-hop
    traversal order (only relative order matters — edges are ranked by
    first traversal, families by first edge). ``cap_of(u, v)`` returns
    the effective capacity of a directed edge.

    One fused-key sort groups pairs per directed edge (links ascending
    within each edge), and edges sharing a link-set signature — compared
    as the sorted-id byte string, which is set equality — collapse into
    one family. Exposed separately from ``compute_categories`` so the
    incremental-redesign service (``runtime/design_service.py``) can
    regroup a *cached* pair set after membership churn without
    recomputing any routing paths: filtering the pair arrays of a
    departed agent (or appending a joiner's) and regrouping is
    bitwise-identical to recomputing on the rebuilt overlay
    (property-tested in tests/test_design_service.py).
    """
    if not link_arr.size:
        return Categories(members={}, capacity={}, edge_capacity={})
    n_nodes = int(max(eu.max(), ev.max())) + 1
    code = eu * n_nodes + ev
    num_links = m * (m - 1)
    # Sort once by (edge, link); keys are unique after fusing, so the
    # default sort is deterministic. Pairs may repeat only for
    # non-simple hand-built paths; a unique pass collapses them (min
    # rank kept).
    if code.max() <= (2**62) // max(num_links, 1):
        order = np.argsort(code * num_links + link_arr)
    else:  # fused key would overflow int64: two-key lexsort
        order = np.lexsort((link_arr, code))
    code_s, link_s, rank_s = code[order], link_arr[order], rank[order]
    keep = np.ones(code_s.size, dtype=bool)
    keep[1:] = (code_s[1:] != code_s[:-1]) | (link_s[1:] != link_s[:-1])
    if not keep.all():
        first = np.flatnonzero(keep)
        seg_min = np.minimum.reduceat(rank_s, first)
        code_s, link_s, rank_s = code_s[first], link_s[first], seg_min
    # Segment per directed edge; edges ordered by first traversal.
    starts = np.flatnonzero(
        np.concatenate(([True], code_s[1:] != code_s[:-1]))
    )
    ends = np.concatenate((starts[1:], [code_s.size]))
    edge_order = np.argsort(np.minimum.reduceat(rank_s, starts))

    # Decode directed-link ids (i·(m−1) + j − [j>i]) to shared tuples:
    # itertools.product emits exactly the i-major (i, j) order with the
    # diagonal, which one object-array mask removes.
    grid = np.empty(m * m, dtype=object)
    grid[:] = list(itertools.product(range(m), repeat=2))
    link_obj = grid[~np.eye(m, dtype=bool).ravel()]
    # Per unique directed edge (in sorted-segment position): node pair
    # as Python ints, decoded in one vector pass.
    seg_code = code_s[starts]
    seg_u = (seg_code // n_nodes).tolist()
    seg_v = (seg_code % n_nodes).tolist()
    starts_l, ends_l = starts.tolist(), ends.tolist()

    fam_of_sig: dict[bytes, int] = {}
    fam_keys: list[frozenset] = []
    fam_members: list[list] = []
    fam_cap: list[float] = []
    fam_ids: list[np.ndarray] = []
    edge_capacity: dict[tuple[int, int], float] = {}
    for pos in edge_order.tolist():
        ids = link_s[starts_l[pos]:ends_l[pos]]
        sig = ids.tobytes()
        fi = fam_of_sig.get(sig)
        if fi is None:
            fi = len(fam_keys)
            fam_of_sig[sig] = fi
            fam_keys.append(frozenset(link_obj[ids].tolist()))
            fam_members.append([])
            fam_cap.append(np.inf)
            fam_ids.append(ids)
        edge = (seg_u[pos], seg_v[pos])
        cval = cap_of(*edge)
        fam_members[fi].append(edge)
        edge_capacity[edge] = cval
        fam_cap[fi] = min(fam_cap[fi], cval)

    # Precompile the capacity-independent CSR half of the incidence:
    # decode family-major ids ℓ = i·(m−1) + j − [j>i] to dense i·m + j,
    # then sort by the fused unique (link, family) key — the order the
    # reference compiler's stable by-link sort produces.
    all_ids = np.concatenate(fam_ids)
    li = all_ids // (m - 1)
    lj = all_ids % (m - 1)
    lj += lj >= li
    dense = li * m + lj
    nf = len(fam_keys)
    cat = np.repeat(
        np.arange(nf, dtype=np.int64),
        np.asarray([a.size for a in fam_ids], dtype=np.int64),
    )
    if dense.size and int(dense.max()) <= (2**62) // max(nf, 1):
        csr = np.argsort(dense * nf + cat)
    else:
        csr = np.lexsort((cat, dense))
    entry_link, entry_cat = dense[csr], cat[csr]
    flat = _FlatCategories(
        num_agents=m,
        num_categories=nf,
        entry_link=entry_link,
        entry_cat=entry_cat,
        link_ptr=np.concatenate(
            (
                np.zeros(1, dtype=np.int64),
                np.cumsum(
                    np.bincount(entry_link, minlength=m * m),
                    dtype=np.int64,
                ),
            )
        ),
    )
    return Categories(
        members={
            F: tuple(v) for F, v in zip(fam_keys, fam_members)
        },
        capacity=dict(zip(fam_keys, fam_cap)),
        edge_capacity=edge_capacity,
        flat=flat,
    )


def edge_category_index(categories: Categories) -> dict:
    """Directed member edge → tuple of family indices containing it.

    The lookup structure incremental capacity patching runs off: a
    ``LinkStateChange`` names underlay edges, and only the families that
    contain a changed edge need their C_F re-derived. Built once per
    category *structure* (membership epoch); capacity-only patches keep
    it valid because ``patch_categories_capacity`` never moves an edge
    between families.
    """
    index: dict[tuple[int, int], list[int]] = {}
    for fi, edges in enumerate(categories.members.values()):
        for e in edges:
            index.setdefault(e, []).append(fi)
    return {e: tuple(v) for e, v in index.items()}


def patch_categories_capacity(
    categories: Categories,
    changed: Mapping,
    edge_index: Mapping | None = None,
) -> "tuple[Categories, np.ndarray]":
    """Re-derive only the touched C_F after a per-edge capacity change.

    ``changed`` maps directed underlay edges (as stored in
    ``categories.edge_capacity``) to their new *absolute* effective
    capacities. Family structure is capacity-independent (routing is
    hop-count), so ``members``/``flat`` are shared unchanged and only the
    families containing a changed edge — found via ``edge_index``
    (``edge_category_index``; rebuilt here when not supplied) — get
    their bottleneck min re-derived, in stored member-edge order, which
    is the reference's traversal order. The result is bitwise-identical
    to ``compute_categories`` on the mutated underlay (property-tested),
    at O(changed members) instead of O(all pairs).

    Returns ``(patched, touched)`` where ``touched`` is the sorted int64
    array of re-derived family indices (what
    ``patch_category_incidence`` needs). Requires ground-truth
    categories (``compute_categories``); inferred categories withhold
    members/edge capacities and raise.
    """
    if categories.edge_capacity is None or not all(
        categories.members.values()
    ):
        raise ValueError(
            "capacity patching needs ground-truth members and edge "
            "capacities (compute_categories); inferred categories "
            "cannot re-derive per-family bottlenecks"
        )
    unknown = [e for e in changed if e not in categories.edge_capacity]
    if unknown:
        raise ValueError(
            f"changed edges {unknown[:4]} are not member edges of any "
            "category — non-traversed edges never constrain and need no "
            "patch (filter against edge_category_index first)"
        )
    if edge_index is None:
        edge_index = edge_category_index(categories)
    touched_set = {
        fi for e in changed for fi in edge_index.get(e, ())
    }
    touched = np.asarray(sorted(touched_set), dtype=np.int64)
    edge_capacity = dict(categories.edge_capacity)
    for e, c in changed.items():
        edge_capacity[e] = float(c)
    if any(edge_capacity[e] <= 0 for e in changed):
        raise ValueError("patched capacities must be positive")
    members = list(categories.members.items())
    capacity = dict(categories.capacity)
    for fi in touched.tolist():
        F, edges = members[fi]
        # Same incremental min, in member (= traversal) order, as the
        # from-scratch grouping loop.
        c = np.inf
        for e in edges:
            c = min(c, edge_capacity[e])
        capacity[F] = c
    return (
        Categories(
            members=categories.members,
            capacity=capacity,
            edge_capacity=edge_capacity,
            flat=categories.flat,  # capacity-independent, shared
        ),
        touched,
    )


def category_entry_order(
    incidence: CategoryIncidence,
) -> tuple[np.ndarray, np.ndarray]:
    """Category-major CSR view over an incidence's entry positions.

    Returns ``(order, ptr)``: ``order[ptr[F]:ptr[F+1]]`` are the entry
    positions of family F. Built once per structure epoch so
    ``patch_category_incidence`` touches exactly the entries of the
    families a capacity event changed instead of re-gathering all nnz.
    """
    order = np.argsort(incidence.entry_cat, kind="stable")
    ptr = np.concatenate(
        (
            np.zeros(1, dtype=np.int64),
            np.cumsum(
                np.bincount(
                    incidence.entry_cat,
                    minlength=incidence.num_categories,
                ),
                dtype=np.int64,
            ),
        )
    )
    return order, ptr


def patch_category_incidence(
    incidence: CategoryIncidence,
    categories: Categories,
    touched: np.ndarray,
    entry_index: tuple[np.ndarray, np.ndarray] | None = None,
) -> CategoryIncidence:
    """Patch an incidence in place of a full recompile after a
    capacity-only change.

    ``categories`` is the ``patch_categories_capacity`` output and
    ``touched`` its re-derived family indices: only those rows of
    ``capacity`` move, and only the entries belonging to them (located
    via ``entry_index`` from ``category_entry_order``; rebuilt here when
    not supplied) get their κ/C_F coefficient recomputed — the same
    elementwise float64 division the full compile performs, so the
    result is bitwise-identical to ``compile_category_incidence`` on the
    patched categories (property-tested). Runs through
    ``dataclasses.replace``, so the CSR contracts re-validate the
    patched structure under ``REPRO_VALIDATE=1``.
    """
    touched = np.asarray(touched, dtype=np.int64)
    caps = list(categories.capacity.values())
    if len(caps) != incidence.num_categories:
        raise ValueError(
            f"patched categories have {len(caps)} families, incidence "
            f"was compiled for {incidence.num_categories}"
        )
    if not touched.size:
        return dataclasses.replace(incidence, source=categories)
    cap = incidence.capacity.copy()
    cap[touched] = np.asarray(
        [caps[fi] for fi in touched.tolist()], dtype=np.float64
    )
    coef = incidence.entry_coef.copy()
    if entry_index is None:
        entry_index = category_entry_order(incidence)
    order, ptr = entry_index
    starts = ptr[touched]
    lens = ptr[touched + 1] - starts
    total = int(lens.sum())
    if total:
        cum = np.concatenate(([0], np.cumsum(lens)[:-1]))
        pos = order[
            np.arange(total) + np.repeat(starts - cum, lens)
        ]
        coef[pos] = incidence.kappa / cap[incidence.entry_cat[pos]]
    return dataclasses.replace(
        incidence, capacity=cap, entry_coef=coef, source=categories
    )


def infer_categories(
    overlay: OverlayNetwork,
    capacity_noise: float = 0.0,
    seed: int = 0,
) -> Categories:
    """Tomography-style estimate of (𝓕, C_F) available to the overlay.

    [17] shows the overlay can *consistently* estimate the nonempty
    categories and each category's bottleneck capacity from end-to-end
    measurements alone. We model the estimator's output: exact category
    structure, with optional multiplicative noise on capacities to stress
    designs against estimation error (``capacity_noise`` = relative std).
    Members are withheld — the overlay never learns which physical links
    form Γ_F, matching the information model of §III-A3.
    """
    truth = compute_categories(overlay)
    rng = np.random.default_rng(seed)
    cap = {}
    for F, c in truth.capacity.items():
        noise = 1.0 + capacity_noise * rng.standard_normal()
        # Clamp to a *relative* floor (1% of the true C_F): an absolute
        # epsilon floor would let a large negative noise draw shrink a
        # capacity by ~9 orders of magnitude, silently blowing up every
        # κ/C_F term and poisoning sweep comparisons. No consistent
        # tomography estimator is off by 100×; cap the modeled error
        # there and keep τ finite and sane.
        cap[F] = float(max(c * noise, 0.01 * c))
    return Categories(
        members={F: () for F in truth.capacity},
        capacity=cap,
        flat=truth.flat,  # same families: the incidence structure holds
    )
