"""Frank-Wolfe Mixing Matrix Design — FMMD and variants (paper Alg. 1).

Minimizes ρ(W) = ‖W − J‖ over conv(S⁺), the convex hull of the swapping
matrices plus identity (Lemma III.4): after T Frank-Wolfe iterations the
solution combines ≤ T atoms, hence activates ≤ T overlay links, which
bounds the per-iteration communication time (Theorem III.5):

    τ(W^(T)) · K(ρ(W^(T))) ≤ (κT/C_min) · K((m−3)/m + 16/(T+2)).

Variants (paper §III-B2, "Further Improvements"):
  * FMMD-W  — re-optimize the weights on the selected support via (14).
  * FMMD-P  — restrict the atom search (19) to unselected atoms that
    minimize the default-path time bound τ̄ (22)-(23).
  * FMMD-WP — both (the paper's headline algorithm).

The port's own copy of the JAX package's ``core/fmmd.py``: the Frank-Wolfe
loop, its eigendecompositions and the priority filter are host numpy,
bitwise the reference's; only the -W weight optimization
(``weight_opt.optimize_weights``) runs on ``device`` (``None`` means
CUDA).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

import torch

from repro_torch.core import mixing
from repro_torch.core.weight_opt import optimize_weights
from repro_torch.net.categories import (
    Categories,
    CategoryIncidence,
    compile_category_incidence,
)


@dataclasses.dataclass(frozen=True)
class FMMDResult:
    matrix: np.ndarray
    activated_links: tuple[tuple[int, int], ...]
    rho: float
    rho_trajectory: tuple[float, ...]
    selected_atoms: tuple[tuple[int, int] | None, ...]  # None = identity atom
    design_seconds: float
    variant: str


def _tau_bar(
    links: frozenset,
    categories: Categories,
    kappa: float,
    incidence: CategoryIncidence | None = None,
) -> float:
    """τ̄(W) of eq. (22): completion time under default-path routing.

    ``links`` holds undirected activated links; each contributes both
    directed unicast flows (i→j and j→i) to its categories. With a
    matching precompiled ``incidence`` the t_F loads come from CSR
    slices instead of the O(Σ_F |F|) family iteration — bitwise equal
    (integer loads are exact in either summation order, and the
    κ·t_F/C_F max uses the same per-element arithmetic).
    """
    uses = {}
    for (i, j) in links:
        uses[(i, j)] = 1
        uses[(j, i)] = 1
    if (
        incidence is not None
        and incidence.kappa == kappa
        and incidence.matches(categories)
    ):
        return incidence.completion_time(incidence.loads_from_uses(uses))
    return categories.completion_time(uses, kappa)


def _csr_gather(
    ptr: np.ndarray, data: np.ndarray, ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate ``data[ptr[id]:ptr[id+1]]`` for every id (a multi-slice
    gather without a Python loop), plus the owning position per entry."""
    starts = ptr[ids]
    lens = ptr[ids + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=data.dtype), np.empty(0, dtype=np.int64)
    cum = np.concatenate(([0], np.cumsum(lens)[:-1]))
    pos = np.arange(total) + np.repeat(starts - cum, lens)
    owner = np.repeat(np.arange(ids.size), lens)
    return data[pos], owner


class _PriorityState:
    """Incremental category loads for the FMMD-P atom filter (eq. 23).

    The reference filter rebuilt the τ̄ link-uses dict per atom per
    Frank-Wolfe iteration — O(|atoms| · Σ_F |F|) in Python, the designer
    bottleneck at 100+ agents. Here the atom→category incidence (δ_F per
    atom, counting both directed links) is flattened once, the selected
    loads t_F live in a numpy array updated on atom selection, and each
    iteration's candidate τ̄ table is

        τ̄(sel ∪ {a}) = max(max_F κ·t_F/C_F,  max_{F ∋ a} κ·(t_F+δ)/C_F),

    exact because adding an atom can only raise the loads of the
    categories it touches. The per-element arithmetic matches
    ``Categories.completion_time`` bit for bit, so the candidate set —
    down to the reference's 1e-15 tie margin — is unchanged.

    The per-atom maxima are maintained *incrementally*: loads only ever
    grow (atoms are only selected, never dropped), so every entry's
    κ·(t_F+δ)/C_F is nondecreasing and a running elementwise max over
    re-evaluations of just the categories a selection touched equals
    the full recomputation — making each Frank-Wolfe iteration's filter
    O(1) Python (one vector max against the current τ̄) instead of a
    ``maximum.at`` scatter over every (atom, category) pair per step.
    """

    def __init__(
        self,
        atoms,
        m: int,
        categories: Categories,
        kappa: float,
        incidence: CategoryIncidence | None = None,
    ):
        if incidence is not None and (
            incidence.num_agents != m
            or incidence.kappa != kappa
            or not incidence.matches(categories)
        ):
            raise ValueError("incidence does not match (categories, m, κ)")
        inc = (
            incidence
            if incidence is not None
            else compile_category_incidence(categories, m, kappa)
        )
        self.kappa = kappa
        self.cap = inc.capacity
        self.num_categories = inc.num_categories
        self.loads = np.zeros(inc.num_categories)
        self._inc = inc
        self._m = m
        atoms_arr = np.asarray(
            [(i, j) for i, j in atoms], dtype=np.int64
        ).reshape(-1, 2)
        self._num_atoms = atoms_arr.shape[0]
        ai, aj = atoms_arr[:, 0], atoms_arr[:, 1]
        cats_f, own_f = _csr_gather(inc.link_ptr, inc.entry_cat, ai * m + aj)
        cats_r, own_r = _csr_gather(inc.link_ptr, inc.entry_cat, aj * m + ai)
        nf = max(inc.num_categories, 1)
        key = (
            np.concatenate([own_f, own_r]) * nf
            + np.concatenate([cats_f, cats_r])
        )
        ukey, counts = np.unique(key, return_counts=True)
        self.entry_atom = ukey // nf  # atom position per (atom, cat) pair
        self.entry_cat = ukey % nf
        self.entry_delta = counts.astype(np.float64)  # δ ∈ {1, 2}
        # Category-major CSR over the (atom, cat) entries, so a selection
        # can re-evaluate exactly the entries of the categories whose
        # loads it changed.
        order = np.argsort(self.entry_cat, kind="stable")
        self._entries_by_cat = order
        self._cat_ptr = np.concatenate(
            (
                np.zeros(1, dtype=np.int64),
                np.cumsum(
                    np.bincount(
                        self.entry_cat, minlength=self.num_categories
                    ),
                    dtype=np.int64,
                ),
            )
        )
        # Running per-atom max of κ·(t_F+δ)/C_F (−inf for category-free
        # atoms, like the reference table's fill value).
        self._rebuild_atom_max()

    def _rebuild_atom_max(self) -> None:
        self._atom_max = np.full(self._num_atoms, -np.inf)
        if self.entry_atom.size:
            np.maximum.at(
                self._atom_max, self.entry_atom,
                self.kappa
                * (self.loads[self.entry_cat] + self.entry_delta)
                / self.cap[self.entry_cat],
            )

    def reset(
        self, incidence: CategoryIncidence | None = None
    ) -> "_PriorityState":
        """Warm-start for a fresh FMMD run, optionally rebinding to a
        capacity-only rescale/patch of the compiled incidence.

        The atom→category entry arrays are capacity-independent (family
        structure is pinned by routing paths), so after a
        ``LinkStateChange`` the service loop reuses them verbatim: only
        ``cap`` is swapped, the selected loads zeroed, and the per-atom
        maxima rebuilt with the same vector op ``__init__`` uses — the
        expensive CSR gather + unique over every (atom, category) pair
        is skipped. Bitwise-identical to constructing a cold state from
        the patched incidence (property-tested). Returns ``self``.
        """
        if incidence is not None:
            if (
                incidence.num_agents != self._m
                or incidence.num_categories != self.num_categories
                or incidence.kappa != self.kappa
            ):
                raise ValueError(
                    "reset incidence must be a capacity-only rescale of "
                    "the compiled structure (same m, #categories, κ)"
                )
            self.cap = incidence.capacity
            self._inc = incidence
        self.loads = np.zeros(self.num_categories)
        self._rebuild_atom_max()
        return self

    def select(self, atom: tuple[int, int]) -> None:
        """Account (i, j) and (j, i) loads for a newly selected atom."""
        i, j = atom
        inc, m = self._inc, self._m
        cats_f = inc.link_categories(i * m + j)
        cats_r = inc.link_categories(j * m + i)
        self.loads[cats_f] += 1.0
        self.loads[cats_r] += 1.0
        touched = np.unique(np.concatenate((cats_f, cats_r)))
        if not touched.size or not self.entry_atom.size:
            return
        pos, _ = _csr_gather(self._cat_ptr, self._entries_by_cat, touched)
        if pos.size:
            cats = self.entry_cat[pos]
            np.maximum.at(
                self._atom_max, self.entry_atom[pos],
                self.kappa
                * (self.loads[cats] + self.entry_delta[pos])
                / self.cap[cats],
            )

    def current_tau(self) -> float:
        if not self.num_categories:
            return 0.0
        return float(np.max(self.kappa * self.loads / self.cap))

    def candidate_taus(self, num_atoms: int) -> np.ndarray:
        """τ̄ of the tentative iterate per atom, as one vector op."""
        if num_atoms != self._num_atoms:
            raise ValueError(
                f"state was built for {self._num_atoms} atoms, "
                f"got {num_atoms}"
            )
        return np.maximum(self._atom_max, self.current_tau())


def fmmd(
    m: int,
    iterations: int,
    categories: Categories | None = None,
    kappa: float = 1.0,
    weight_opt: bool = False,
    priority: bool = False,
    allowed_links: Sequence[tuple[int, int]] | None = None,
    incidence: CategoryIncidence | None = None,
    warm_state: "_PriorityState | None" = None,
    device: str | torch.device | None = None,
) -> FMMDResult:
    """Run FMMD (Alg. 1) with optional -W / -P improvements.

    ``allowed_links`` restricts the atom set for non-fully-connected
    overlays (paper footnote 1). ``categories``/``kappa`` are required
    when ``priority=True`` (the τ̄ bound needs network knowledge);
    ``incidence`` (a matching precompiled ``CategoryIncidence``) skips
    the priority filter's category compilation, e.g. across a sweep.
    ``warm_state`` (a ``_PriorityState`` the caller already ``reset()``)
    skips the priority filter's atom→category flattening entirely — the
    incremental-redesign path: after a capacity-only network change the
    service loop rebinds the incumbent state to the patched incidence
    and re-runs the design with zero structural setup. The caller owns
    the contract that the state was built for the SAME atom list, m,
    and κ (atom count and m are checked; atom identity cannot be
    cheaply verified). ``device`` is where the -W weight optimization
    runs (``None`` means CUDA).
    """
    if priority and categories is None:
        raise ValueError("FMMD-P needs categories (τ̄ bound)")
    t0 = time.perf_counter()

    if allowed_links is None:
        atoms = [(i, j) for i in range(m) for j in range(i + 1, m)]
    else:
        atoms = [tuple(sorted(l)) for l in allowed_links]

    w = np.eye(m)  # W^(0) = I (an atom in S⁺)
    selected: list[tuple[int, int] | None] = []
    selected_links: set[tuple[int, int]] = set()
    trajectory: list[float] = [mixing.rho(w)]

    num_atoms = len(atoms)
    atoms_ij = np.asarray(atoms, dtype=np.int64).reshape(-1, 2)
    ai, aj = atoms_ij[:, 0], atoms_ij[:, 1]
    prio = None
    if priority:
        if warm_state is not None:
            if warm_state._num_atoms != num_atoms or warm_state._m != m:
                raise ValueError(
                    f"warm_state was built for {warm_state._num_atoms} "
                    f"atoms at m={warm_state._m}, this run has "
                    f"{num_atoms} atoms at m={m}"
                )
            if warm_state.kappa != kappa:
                raise ValueError("warm_state κ does not match")
            prio = warm_state
        else:
            prio = _PriorityState(
                atoms, m, categories, kappa, incidence=incidence
            )
    # Persistent unselected-atom mask, flipped on selection — replaces
    # the per-iteration O(|atoms|) ``np.fromiter`` set-membership
    # rebuild. ``atoms`` may contain duplicate values (caller-supplied
    # ``allowed_links``): every position of a selected value flips.
    unsel_mask = np.ones(num_atoms, dtype=bool)
    atom_positions: dict[tuple[int, int], list[int]] = {}
    for q, a in enumerate(atoms):
        atom_positions.setdefault(a, []).append(q)

    for k in range(iterations):
        rho_k, grad = mixing.rho_and_gradient(w)  # eq. (18), one eigh
        if k > 0:
            trajectory.append(rho_k)  # ρ(W^(k)) from the same factoring
        gamma = 2.0 / (k + 2.0)

        # Inner products <S, ∇ρ> for all atoms (eq. 19), vectorized:
        #   <I, G> = tr(G);  <S^(i,j), G> = tr(G) − (G_ii + G_jj − 2 G_ij).
        tr = float(np.trace(grad))
        diag = np.diagonal(grad)
        scores = tr - ((diag[ai] + diag[aj]) - 2.0 * grad[ai, aj])

        cand_mask = None
        if priority:
            # (23): among UNSELECTED atoms, keep only those minimizing the
            # τ̄ of the tentative iterate. The identity atom constructs
            # W^(0), so it is in S(W^(k)) from the start and is excluded —
            # otherwise it would always win (it never increases τ̄) and the
            # algorithm would stall.
            if unsel_mask.any():
                taus = np.where(
                    unsel_mask, prio.candidate_taus(num_atoms), np.inf
                )
                cand_mask = unsel_mask & (taus <= taus.min() + 1e-15)
            # else: every link already activated → full search incl. I

        if cand_mask is not None:
            atom = atoms[int(np.argmin(np.where(cand_mask, scores, np.inf)))]
        elif num_atoms and tr > scores.min():
            atom = atoms[int(np.argmin(scores))]
        else:  # identity first in candidate order: wins score ties
            atom = None
        mixing.fw_step(w, gamma, atom)  # W ← (1−γ)W + γS, in place
        selected.append(atom)
        if atom is not None and atom not in selected_links:
            selected_links.add(atom)
            for q in atom_positions[atom]:
                unsel_mask[q] = False
            if prio is not None:
                prio.select(atom)
    rho_final = mixing.rho(w) if iterations > 0 else trajectory[0]
    if iterations > 0:
        trajectory.append(rho_final)  # ρ(W^(T)), reused for the result

    links = tuple(sorted(selected_links))
    variant = "FMMD" + ("-W" if weight_opt else "") + ("-P" if priority else "")
    if weight_opt and links:
        res = optimize_weights(m, links, device=device)
        w = res.matrix
        # weight optimization may zero out some links; recompute support
        links_w, _ = mixing.weights_from_matrix(w)
        links = tuple(links_w)
        rho_final = mixing.rho(w)  # weight opt rewrote the iterate
    mixing.validate_mixing(w)
    return FMMDResult(
        matrix=w,
        activated_links=links,
        rho=rho_final,
        rho_trajectory=tuple(trajectory),
        selected_atoms=tuple(selected),
        design_seconds=time.perf_counter() - t0,
        variant=variant.replace("-W-P", "-WP"),
    )


def fmmd_wp(
    m: int,
    iterations: int,
    categories: Categories,
    kappa: float,
    allowed_links: Sequence[tuple[int, int]] | None = None,
    incidence: CategoryIncidence | None = None,
    device: str | torch.device | None = None,
) -> FMMDResult:
    """FMMD-WP — the paper's best-performing variant."""
    return fmmd(
        m,
        iterations,
        categories=categories,
        kappa=kappa,
        weight_opt=True,
        priority=True,
        allowed_links=allowed_links,
        incidence=incidence,
        device=device,
    )


def theorem35_bound(
    m: int,
    iterations: int,
    c_min: float,
    kappa: float,
    constants: mixing.ConvergenceConstants = mixing.ConvergenceConstants(),
) -> float:
    """Right-hand side of the Theorem III.5 guarantee (eq. 20)."""
    if m <= 3 or iterations <= 16 * m / 3 - 2:
        raise ValueError("bound requires m > 3 and T > 16m/3 − 2")
    rho_bound = (m - 3.0) / m + 16.0 / (iterations + 2.0)
    return (kappa * iterations / c_min) * mixing.iterations_to_converge(
        rho_bound, m, constants
    )
