"""Batched rollout engine in float64 torch ops: Monte-Carlo pricing on the GPU.

Counterpart of the JAX package's ``net/jax_engine.py``. The numpy engines
in ``net/simulator.py`` price one scenario at a time from a Python event
loop; this module runs the batched water-filling engine
(``engine="batched"``, the parity oracle) for a whole stochastic batch in
lockstep on the device, with the rollout axis stored *last* on every
array ([rows, R]).

Two halves:

* the host half — ``DeviceIncidence`` and its padding (``_bucket``,
  ``_table_width``, ``_pack_table``, ``device_incidence``), the churn
  lowering (``branch_cancel_times``, ``batch_cancel_times``) and
  ``device_args`` — is the reference's numpy, verbatim;
* the device half — ``_table_any``/``_table_count``, ``_waterfill`` and
  ``_simulate_batch`` — is the reference's ``lax`` code as torch ops.
  Segment reductions gather table rows with ``index_select`` over the
  static table width; the piecewise-constant scenario timeline is a
  Python loop over the phase boundaries; each ``lax.while_loop`` is a
  Python ``while`` that reads one ``.any()`` back per iteration (per
  double water-fill round, per event). Those reads are the engine's host
  synchronisations: ``sync_count()`` counts them (with the one copy of
  the results at the end), ``reset_sync_count()`` sets the count to 0.

Scope: ``fairness="maxmin"``, capacity phases and churn — the paths
stochastic pricing exercises. Cross-traffic and straggler events need the
host event loop; entries here reject them with the ``engine="batched"``
fallback spelled out. Parity: per-rollout makespan/flow completion match
``engine="batched"`` to rtol=1e-9 on the same realizations, and the event
arithmetic — tie detection by exact fp equality, breakpoint landing
(``t = t_end``, no drift), the 1e-9·κ finish threshold — is the numpy
loop's term for term; the capacity drain per round is grouped
(``smin × crossings``), as in the reference engine.

float64 is load-bearing: every tensor here is created float64 (or bool,
or an integer count) explicitly — torch's default float32 would silently
break the rtol=1e-9 contract.

``device=None`` means CUDA and raises ``compat.NoCudaDeviceError``
without a card; ``device="cpu"`` runs the same ops on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.analysis.contracts import maybe_validate
from repro_torch.net.simulator import (
    BranchIncidence,
    ChurnEvent,
    Scenario,
    SimResult,
    _collect_result,
    compile_incidence,
)
from repro_torch.net.stochastic import (
    RealizationBatch,
    densify_realizations,
)

F64 = torch.float64
INF = float("inf")

_syncs = 0
_rounds = 0


def sync_count() -> int:
    """Device-to-host reads made by the engine since the last reset: one
    per loop test (event loop and double water-fill round) and one per
    batch for the results."""
    return _syncs


def round_count() -> int:
    """Water-fill rounds run since the last reset, in lockstep over the
    batch (two per loop test of ``_waterfill``)."""
    return _rounds


def reset_sync_count() -> None:
    """Set the sync and round counts to 0."""
    global _syncs, _rounds
    _syncs = 0
    _rounds = 0


def _read_any(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``: one host synchronisation, counted."""
    global _syncs
    _syncs += 1
    return bool(mask.any())


# ---------------------------------------------------------------------------
# Device-CSR layout (host numpy, verbatim)
# ---------------------------------------------------------------------------


def _bucket(n: int) -> int:
    """Smallest power-of-two >= max(8, n + 1).

    Every axis is padded to a bucket so (a) nearby design sizes share one
    tensor shape, and (b) each axis keeps at least one inert padding row —
    padding entries can always point at branch ``num_branches`` / edge
    ``num_edges`` even when the real count is itself a power of two.
    """
    return max(8, 1 << int(n).bit_length())


@dataclasses.dataclass(frozen=True)
class DeviceIncidence:
    """Padded device-CSR mirror of a ``BranchIncidence``.

    Arrays are host numpy (shipped to the device per launch); shapes are
    power-of-two buckets of the real sizes. Padding is inert by
    construction: padding entries point at the padding branch
    ``num_branches`` (never active, size 0) and the padding edge
    ``num_edges`` (capacity 1.0, crossed only by padding entries, so its
    count is always zero and its share always inf).

    Two entry orderings ride along: ``flat_branch``/``flat_edge`` are
    branch-major (as in the source incidence — ``flat_branch`` ascending)
    and ``edge_branch``/``edge_edge`` are edge-major (``edge_edge``
    ascending — the source's CSC order). ``branch_ptr``/``edge_ptr``
    extend the source CSR pointers over the padded rows (the pad row owns
    exactly the pad entries, every row past it is empty).

    The device loops consume the bounded-degree *tables* derived from
    those pointers: ``branch_table[b]`` lists the edges branch ``b``
    crosses (padded with the inert edge ``E``) and ``edge_table[e]`` lists
    the branches crossing edge ``e`` (padded with the inert branch ``B``).
    With the rollout axis last ([rows, R] tensors), a table column lookup
    is one contiguous-row gather. Prefixes are bitwise-equal to the source
    arrays (validated under ``REPRO_VALIDATE=1`` by
    ``repro_torch.analysis.contracts.validate_device_incidence``).
    """

    source: BranchIncidence
    num_branches: int
    num_edges: int
    num_entries: int
    flat_branch: np.ndarray  # [Z] int64, branch-major; padding -> B
    flat_edge: np.ndarray  # [Z] int64, branch-major; padding -> E
    edge_branch: np.ndarray  # [Z] int64, edge-major; padding -> B
    edge_edge: np.ndarray  # [Z] int64, edge-major ascending; padding -> E
    branch_ptr: np.ndarray  # [B_pad+1] int64 CSR ptr into flat_* arrays
    edge_ptr: np.ndarray  # [E_pad+1] int64 CSR ptr into edge_* arrays
    branch_table: np.ndarray  # [B_pad, D] int32 edges per branch; pad -> E
    edge_table: np.ndarray  # [E_pad, K] int32 branches per edge; pad -> B
    base_capacity: np.ndarray  # [E_pad] float64; padding 1.0
    sizes: np.ndarray  # [B_pad] float64 per-branch demand; padding 0.0

    def __post_init__(self):
        # Padded-layout contract; no-op unless REPRO_VALIDATE=1
        # (repro_torch.analysis.contracts.validate_device_incidence).
        maybe_validate(self)

    @property
    def padded_branches(self) -> int:
        return self.sizes.size

    @property
    def padded_edges(self) -> int:
        return self.base_capacity.size


def _table_width(max_degree: int) -> int:
    """Smallest power-of-two >= max(2, max_degree) — bucketed so nearby
    instances share shapes, floored at 2 so the table reduction always has
    a fixed minimum width."""
    return max(2, 1 << max(0, int(max_degree) - 1).bit_length())


def _pack_table(
    ptr: np.ndarray, values: np.ndarray, rows: int, fill: int
) -> np.ndarray:
    """[rows, W] int32 table of each CSR row's values.

    ``W`` is the bucketed max real row degree; short rows and pad rows
    (real row count up to ``rows``) are filled with ``fill`` — the inert
    pad index whose mask value is always False, so table padding
    contributes exactly zero to every reduction."""
    deg = np.diff(ptr)
    width = _table_width(int(deg.max(initial=0)))
    table = np.full((rows, width), fill, dtype=np.int32)
    real = deg.size
    cols = np.arange(width)[None, :]
    mask = cols < deg[:, None]
    table[:real][mask] = values
    return table


def device_incidence(
    inc: BranchIncidence, flow_size: np.ndarray
) -> DeviceIncidence:
    """Pad ``inc`` into the device layout.

    ``flow_size[h]`` is demand h's size in bytes; per-branch sizes are
    gathered through ``inc.flows``. The edge-major ordering reuses the
    source's CSC arrays (``edge_branch`` + the edge ids its ``edge_ptr``
    implies), so no re-sort happens here.
    """
    nb, ne = inc.num_branches, inc.num_edges
    nnz = inc.flat_branch.size
    bp, ep, zp = _bucket(nb), _bucket(ne), _bucket(nnz)
    fb = np.full(zp, nb, dtype=np.int64)
    fb[:nnz] = inc.flat_branch
    fe = np.full(zp, ne, dtype=np.int64)
    fe[:nnz] = inc.flat_edge
    eb = np.full(zp, nb, dtype=np.int64)
    eb[:nnz] = inc.edge_branch
    ee = np.full(zp, ne, dtype=np.int64)
    ee[:nnz] = np.repeat(
        np.arange(ne, dtype=np.int64), np.diff(inc.edge_ptr)
    )
    cap = np.ones(ep, dtype=np.float64)
    cap[:ne] = inc.base_capacity
    sizes = np.zeros(bp, dtype=np.float64)
    sizes[:nb] = flow_size[inc.flows]
    # Padded CSR pointers: the pad row (branch nb / edge ne) owns the
    # pad entries [nnz, zp); every row past it is empty at zp.
    bptr = np.full(bp + 1, zp, dtype=np.int64)
    bptr[: nb + 1] = inc.branch_ptr
    eptr = np.full(ep + 1, zp, dtype=np.int64)
    eptr[: ne + 1] = inc.edge_ptr
    return DeviceIncidence(
        source=inc,
        num_branches=nb,
        num_edges=ne,
        num_entries=nnz,
        flat_branch=fb,
        flat_edge=fe,
        edge_branch=eb,
        edge_edge=ee,
        branch_ptr=bptr,
        edge_ptr=eptr,
        branch_table=_pack_table(
            inc.branch_ptr, inc.flat_edge, bp, fill=ne
        ),
        edge_table=_pack_table(
            inc.edge_ptr, inc.edge_branch, ep, fill=nb
        ),
        base_capacity=cap,
        sizes=sizes,
    )


# ---------------------------------------------------------------------------
# Scenario lowering (host side, verbatim)
# ---------------------------------------------------------------------------


def _check_supported(scenario: Scenario | None, fairness: str) -> None:
    if fairness != "maxmin":
        raise ValueError(
            "engine='torch' implements fairness='maxmin' only; price "
            "equal-share allocations with engine='batched'"
        )
    if scenario is not None and (
        scenario.cross_traffic or scenario.stragglers
    ):
        raise ValueError(
            "engine='torch' lowers capacity phases and churn only; "
            "cross-traffic and straggler events need the host event "
            "loop — price this scenario with engine='batched'"
        )


def branch_cancel_times(
    inc: BranchIncidence,
    flow_source: np.ndarray,
    churn: Sequence[ChurnEvent],
) -> np.ndarray:
    """Earliest departure cancelling each branch ([B] float64, +inf when
    none) — churn lowered to a static per-branch quantity so per-rollout
    departure times stay one dense lane axis. A departure hits branches on
    overlay links touching the agent and all branches of flows it
    sources, exactly the numpy loop's rule."""
    cancel = np.full(inc.num_branches, np.inf, dtype=np.float64)
    src = flow_source[inc.flows]
    for ev in churn:
        hit = (
            (inc.links[:, 0] == ev.agent)
            | (inc.links[:, 1] == ev.agent)
            | (src == ev.agent)
        )
        np.minimum(
            cancel, np.where(hit, float(ev.time), np.inf), out=cancel
        )
    return cancel


def batch_cancel_times(
    inc: BranchIncidence,
    flow_source: np.ndarray,
    batch: RealizationBatch,
) -> np.ndarray:
    """Per-rollout branch cancellation times ([R, B] float64, +inf when
    none): ``branch_cancel_times`` applied to each realization's churn
    schedule — the host half of the churn lowering that
    ``rollout_batch_results`` feeds to the device."""
    cancel = np.empty(
        (batch.num_rollouts, inc.num_branches), dtype=np.float64
    )
    for r, churn in enumerate(batch.churn):
        cancel[r] = branch_cancel_times(inc, flow_source, churn)
    return cancel


# ---------------------------------------------------------------------------
# Device loops
# ---------------------------------------------------------------------------


def _table_any(mask: torch.Tensor, cols: Sequence[torch.Tensor]):
    """OR-reduce ``mask`` rows through a bounded-degree table given as its
    columns: ``out[i] = any(mask[table[i, k]] for k)``, unrolled over the
    static width; with the rollout axis last each term is one contiguous
    row gather."""
    out = torch.index_select(mask, 0, cols[0])
    for col in cols[1:]:
        out = out | torch.index_select(mask, 0, col)
    return out


def _table_count(mask: torch.Tensor, cols: Sequence[torch.Tensor], dtype):
    """Count-reduce ``mask`` rows through a bounded-degree table:
    ``out[i] = sum(mask[table[i, k]] for k)`` (exact — a count is at most
    the static table width, so int16 suffices below 32768)."""
    out = torch.index_select(mask, 0, cols[0]).to(dtype)
    for col in cols[1:]:
        out = out + torch.index_select(mask, 0, col)
    return out


def _count_dtype(edge_width: int) -> torch.dtype:
    """int16 counts while the edge table is narrower than 2**15, else
    int32 — the reference's ``cdtype`` switch."""
    return torch.int16 if edge_width < 2**15 else torch.int32


def _waterfill(active, caps, branch_cols, edge_cols, cdtype):
    """Batched water-filling — ``_maxmin_rates_batched`` with the
    per-round capacity drain grouped as ``smin × crossings``, every tensor
    carrying the rollout axis *last* ([B_pad, R] / [E_pad, R]).

    The carried state is the reference engine's: unfrozen crossers per
    edge (``counts``, carried across rounds — ``counts - counts_next`` is
    exactly the crossings drained), the share map (computed with the
    drain from the just-updated ``(cap_left, counts)``), and rates stamped
    the round a branch freezes. Tied edges are detected by exact fp
    equality with the lane's minimum share, and every unfrozen crosser of
    a tied edge freezes at ``smin``. Lanes converge independently: a lane
    with nothing unfrozen (or a non-finite minimum share) has an all-inf
    share map, which makes ``ok`` false and every update a no-op. Two
    rounds run per loop test (a round past convergence is an exact
    no-op), and each test is one host synchronisation.
    """
    global _rounds
    num_b, num_r = active.shape
    dev = active.device
    counts = _table_count(active, edge_cols, cdtype)
    share = torch.where(counts > 0, caps / counts.to(F64), INF)
    unfrozen = active
    cap_left = caps
    stop = torch.zeros(num_r, dtype=torch.bool, device=dev)
    rates = torch.zeros((num_b, num_r), dtype=F64, device=dev)
    while _read_any(unfrozen.any(dim=0) & ~stop):
        for _ in range(2):
            smin = torch.amin(share, dim=0)
            finite = torch.isfinite(smin)
            ok = finite & ~stop
            tied = share == smin[None, :]
            # No unfrozen mask on the tied pass: frozen branches crossing
            # a tied edge are filtered branch-side by ``& unfrozen``.
            hit = _table_any(tied, branch_cols)
            freeze = hit & unfrozen & ok[None, :]
            unfrozen = unfrozen & ~freeze
            counts_next = _table_count(unfrozen, edge_cols, cdtype)
            smin_safe = torch.where(ok, smin, 0.0)
            rates = torch.where(freeze, smin_safe[None, :], rates)
            # freeze ⊆ unfrozen, so counts - counts_next is exactly the
            # crossings drained this round, drained as two products.
            cap_left = (
                cap_left
                - smin_safe[None, :] * counts
                + smin_safe[None, :] * counts_next
            )
            share = torch.where(
                counts_next > 0, cap_left / counts_next.to(F64), INF
            )
            counts = counts_next
            stop = stop | ~finite
        _rounds += 2
    return rates


def _simulate_batch(caps_pp, cancel_time, active0, sizes, starts,
                    max_events, branch_cols, edge_cols, cdtype):
    """All rollouts on the device: a loop over the shared boundary grid,
    an event loop per interval — the numpy event loop's arithmetic
    verbatim per lane (dt selection, exact boundary landing, finish
    threshold), with the rollout axis last on every tensor ([B_pad, R]
    state, [P, E_pad, R] capacities). Lanes advance independently: every
    update is masked by the lane's own loop condition (``live``), so
    per-lane results are bitwise those of a one-lane run. Churn applies
    at interval entry (every churn time is a grid boundary). Starvation
    (no positive rate, no future boundary) sets a per-lane flag the host
    raises on. ``starts`` is host numpy; everything else lives on the
    device.

    Returns ``(done_time, cancelled, active, events, starved)``.
    """
    num_b, num_r = active0.shape
    dev = active0.device
    thresh = (1e-9 * sizes)[:, None]
    ends = [float(s) for s in starts[1:]] + [INF]
    t = torch.zeros(num_r, dtype=F64, device=dev)
    remaining = sizes[:, None].expand(num_b, num_r).clone()
    done = torch.full((num_b, num_r), float("nan"), dtype=F64, device=dev)
    cancelled = torch.zeros((num_b, num_r), dtype=torch.bool, device=dev)
    active = active0
    events = torch.zeros(num_r, dtype=torch.int64, device=dev)
    starved = torch.zeros(num_r, dtype=torch.bool, device=dev)
    for p, t_start in enumerate(starts):
        caps, t_start, t_end = caps_pp[p], float(t_start), ends[p]
        newly = active & (cancel_time <= t_start)
        cancelled = cancelled | newly
        active = active & ~newly
        while True:
            live = (
                active.any(dim=0) & (t < t_end) & ~starved
                & (events < max_events)
            )
            if not _read_any(live):
                break
            # Lanes already done this interval enter the water-fill with
            # nothing unfrozen, so they cost no extra rounds and their
            # (zero) rates are discarded by the masks below.
            update = active & live[None, :]
            rates = _waterfill(update, caps, branch_cols, edge_cols, cdtype)
            pos = (torch.where(active, rates, 0.0) > 0.0).any(dim=0)
            starved_now = ~pos & live if t_end == INF else torch.zeros_like(pos)
            dt0 = torch.amin(
                torch.where(
                    active, remaining / torch.clamp_min(rates, 1e-300), INF
                ),
                dim=0,
            )
            bdt = t_end - t
            use_b = bdt < dt0
            dt = torch.where(use_b, bdt, dt0)
            t_new = torch.where(use_b, t_end, t + dt0)
            t_new = torch.where(starved_now, t, t_new)
            # All-nonpositive rates jump to the boundary without draining
            # (numpy's `continue` path); mixed-sign rounds subtract for
            # every active branch as numpy does.
            dt_eff = torch.where(pos, dt, 0.0)
            remaining = torch.where(
                update, remaining - rates * dt_eff[None, :], remaining
            )
            finished = update & (remaining <= thresh)
            done = torch.where(finished, t_new[None, :], done)
            active = active & ~finished
            t = torch.where(live, t_new, t)
            events = events + live.to(torch.int64)
            starved = starved | starved_now
    return done, cancelled, active, events, starved


def _table_columns(table: np.ndarray, device) -> list[torch.Tensor]:
    """A bounded-degree table as its columns, int64 on the device."""
    t = torch.from_numpy(np.ascontiguousarray(table.T, dtype=np.int64))
    return list(t.to(device))


def _run_batch(branch_table, edge_table, sizes, active0, starts, caps,
               cancel, max_events, device) -> np.ndarray:
    """The whole Monte-Carlo batch on ``device``: ``caps`` is [P, E_pad, R]
    and ``cancel``/``active0`` are [B_pad, R] — rollout axis last
    throughout (see ``_simulate_batch``). Returns one host float64 array
    ``[3·B_pad + 2, R]`` — done times, cancelled, still active, events,
    starved — brought back in one copy."""
    branch_cols = _table_columns(branch_table, device)
    edge_cols = _table_columns(edge_table, device)
    cdtype = _count_dtype(edge_table.shape[1])

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype
        )

    done, cancelled, active, events, starved = _simulate_batch(
        put(caps, F64), put(cancel, F64), put(active0, torch.bool),
        put(sizes, F64), np.asarray(starts, dtype=np.float64),
        int(max_events), branch_cols, edge_cols, cdtype,
    )
    packed = torch.cat([
        done, cancelled.to(F64), active.to(F64),
        events.to(F64)[None, :], starved.to(F64)[None, :],
    ])
    global _syncs
    _syncs += 1
    # An explicit copy: on the CPU ``.cpu()`` would dispatch nothing, and
    # the trace lint could not see the read it counts.
    return packed.to("cpu", copy=True).numpy()


# ---------------------------------------------------------------------------
# Host entry points
# ---------------------------------------------------------------------------


def device_args(
    dev: DeviceIncidence,
    starts: np.ndarray,
    caps: np.ndarray,
    cancel_times: np.ndarray,
    max_events: int = 100_000,
) -> tuple:
    """The exact argument tuple ``run_rollouts`` hands ``_run_batch``:
    host-side padding of ``caps`` [R, P, E] / ``cancel_times`` [R, B] into
    the device buckets, rollout axis moved last ([P, E_pad, R] /
    [B_pad, R] — see ``_simulate_batch`` for why the loops want that
    layout)."""
    caps = np.asarray(caps, dtype=np.float64)
    cancel_times = np.asarray(cancel_times, dtype=np.float64)
    rollouts = caps.shape[0]
    nb, ne = dev.num_branches, dev.num_edges
    starts = np.asarray(starts, dtype=np.float64)
    caps_p = np.ones(
        (starts.size, dev.padded_edges, rollouts), dtype=np.float64
    )
    caps_p[:, :ne, :] = np.transpose(caps, (1, 2, 0))
    cancel_p = np.full(
        (dev.padded_branches, rollouts), np.inf, dtype=np.float64
    )
    cancel_p[:nb, :] = cancel_times.T
    active0 = np.zeros((dev.padded_branches, rollouts), dtype=bool)
    active0[:nb, :] = True
    return (
        dev.branch_table, dev.edge_table, dev.sizes, active0, starts,
        caps_p, cancel_p, np.asarray(max_events, dtype=np.int64),
    )


def run_rollouts(
    dev: DeviceIncidence,
    starts: np.ndarray,
    caps: np.ndarray,
    cancel_times: np.ndarray,
    max_events: int = 100_000,
    device=None,
) -> list[tuple[np.ndarray, np.ndarray, int, int]]:
    """Run R rollouts in one device pass; per rollout returns
    ``(done_time[B], cancelled[B], events, unfinished)`` on the real
    (unpadded) branches.

    ``caps`` is [R, P, E] on the source incidence's edges and
    ``cancel_times`` is [R, B]; padding to the device buckets happens in
    ``device_args``. Raises the numpy engines' starvation
    ``RuntimeError`` if any rollout starves (all-zero rates with no
    future boundary).
    """
    device = compat.resolve_device(device)
    nb, pb = dev.num_branches, dev.padded_branches
    rollouts = np.asarray(caps).shape[0]
    packed = _run_batch(
        *device_args(dev, starts, caps, cancel_times, max_events), device
    )
    done = packed[:pb]
    cancelled = packed[pb:2 * pb] != 0.0
    active = packed[2 * pb:3 * pb] != 0.0
    events, starved = packed[3 * pb], packed[3 * pb + 1]
    if bool(np.any(starved != 0.0)):
        raise RuntimeError("starved branches; invalid routing/capacities")
    return [
        (
            done[:nb, r],
            cancelled[:nb, r],
            int(events[r]),
            int(active[:nb, r].sum()),
        )
        for r in range(rollouts)
    ]


def simulate_torch(
    sol,
    overlay,
    fairness: str = "maxmin",
    max_events: int = 100_000,
    scenario: Scenario | None = None,
    incidence: BranchIncidence | None = None,
    extra_boundaries: Sequence[float] = (),
    device=None,
) -> SimResult:
    """``simulate(engine="torch")``: one deterministic run on the device.

    Semantically ``engine="batched"`` for the supported scenario surface
    (maxmin fairness; capacity phases + churn), to rtol=1e-9.
    ``extra_boundaries`` adds grid boundaries (how ``simulate_phased``
    lands exactly on its segment starts).
    """
    device = compat.resolve_device(device)
    _check_supported(scenario, fairness)
    if scenario is not None:
        scenario.validate()
        m = overlay.num_agents
        for ev in scenario.churn:
            if not 0 <= ev.agent < m:
                raise ValueError(
                    f"scenario references agent {ev.agent}, but the "
                    f"overlay has {m} agents"
                )
    if incidence is None:
        branches = sol.unicast_branches(overlay)
        if not branches:
            return SimResult(0.0, tuple(0.0 for _ in sol.demands), 0)
        incidence = compile_incidence(sol, overlay, branches)
    elif incidence.num_branches == 0:
        return SimResult(0.0, tuple(0.0 for _ in sol.demands), 0)
    flow_size = np.array([d.size for d in sol.demands], dtype=np.float64)
    flow_source = np.array(
        [d.source for d in sol.demands], dtype=np.int64
    )
    dev = device_incidence(incidence, flow_size)
    batch = densify_realizations(
        (scenario if scenario is not None else Scenario(),),
        incidence, extra_boundaries=extra_boundaries,
    )
    cancel = branch_cancel_times(
        incidence, flow_source, batch.churn[0]
    )
    ((done, cancelled, events, unfinished),) = run_rollouts(
        dev, batch.starts, batch.capacity, cancel[None], max_events,
        device=device,
    )
    return _collect_result(
        sol, incidence.flows, done, cancelled, events, unfinished
    )


def rollout_batch_results(
    sol,
    dev: DeviceIncidence,
    batch: RealizationBatch,
    max_events: int = 100_000,
    device=None,
) -> tuple[SimResult, ...]:
    """Price every realization in ``batch`` against the precompiled
    ``dev`` in one device pass — the designer's hot path. Returns one
    ``SimResult`` per rollout, in rollout order, with the numpy engines'
    NaN/cancellation semantics (``_collect_result``)."""
    device = compat.resolve_device(device)
    inc = dev.source
    flow_source = np.array(
        [d.source for d in sol.demands], dtype=np.int64
    )
    cancel = batch_cancel_times(inc, flow_source, batch)
    outs = run_rollouts(
        dev, batch.starts, batch.capacity, cancel, max_events,
        device=device,
    )
    return tuple(
        _collect_result(sol, inc.flows, done, cancelled, events, unfin)
        for done, cancelled, events, unfin in outs
    )


def simulate_rollout_batch(
    sol,
    overlay,
    batch: RealizationBatch,
    fairness: str = "maxmin",
    max_events: int = 100_000,
    incidence: BranchIncidence | None = None,
    device=None,
) -> tuple[SimResult, ...]:
    """Price a whole ``RealizationBatch`` in one device pass.

    The incidence is compiled (or taken precompiled) once for the
    activated-link set and shared by every rollout; held against
    ``_rollout_batch_reference`` — the numpy ``engine="batched"`` loop
    over the same realizations — per rollout at rtol=1e-9.
    """
    device = compat.resolve_device(device)
    if fairness != "maxmin":
        raise ValueError(
            "engine='torch' implements fairness='maxmin' only; price "
            "equal-share allocations with engine='batched'"
        )
    if incidence is None:
        incidence = compile_incidence(sol, overlay)
    flow_size = np.array([d.size for d in sol.demands], dtype=np.float64)
    dev = device_incidence(incidence, flow_size)
    return rollout_batch_results(
        sol, dev, batch, max_events=max_events, device=device
    )


def _rollout_batch_reference(
    sol,
    overlay,
    batch: RealizationBatch,
    fairness: str = "maxmin",
    max_events: int = 100_000,
    incidence: BranchIncidence | None = None,
) -> tuple[SimResult, ...]:
    """Numpy oracle for ``simulate_rollout_batch``: the Python rollout
    loop over the batch's realizations with ``engine="batched"`` — the
    host pricing path the device engine is held against."""
    from repro_torch.net.simulator import simulate

    return tuple(
        simulate(
            sol, overlay, fairness=fairness, max_events=max_events,
            scenario=sc, engine="batched", incidence=incidence,
        )
        for sc in batch.realizations
    )
