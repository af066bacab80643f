"""Port `runtime/{design_service,events}.py` against the JAX package: the
same overlays, events and fault plans through both services. With
``engine="batched"`` every record (decision, tier, τ, detail, retries,
faults), the membership, the epoch, the virtual clock, W, the categories
and incidences are bitwise the reference's; the port's
``engine="torch", device="cpu"`` matches the reference's ``"batched"`` at
rtol 1e-9 with the same decision trail. The incremental patches against a
scratch recompile, the warm FMMD against the cold one and the event
sourcing are held as the reference's own tests hold them, and against the
reference's results."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.net as jnet
import repro_torch.net as tnet
from _torch_net import assert_same
from repro import compat as jcompat
from repro.analysis.contracts import ContractViolation as JContractViolation
from repro.core.fmmd import _PriorityState as JPriorityState
from repro.core.fmmd import fmmd as jfmmd
from repro.net import categories as jcat
from repro.net import simulator as jsim
from repro.runtime import design_service as jds
from repro.runtime import events as jev
from repro.runtime import faultinject as jfi
from repro_torch import compat
from repro_torch.analysis.contracts import ContractViolation
from repro_torch.core import mixing
from repro_torch.core.fmmd import _PriorityState, fmmd
from repro_torch.net import categories as tcat
from repro_torch.net import simulator as tsim
from repro_torch.net.stochastic import realization_deltas
from repro_torch.net.topology import OverlayNetwork
from repro_torch.runtime import design_service as tds
from repro_torch.runtime import events as tev
from repro_torch.runtime import faultinject as tfi


@pytest.fixture(autouse=True, scope="module")
def _x64():
    """float64 on in JAX for this file's tests (as in every port test),
    and back as it was after them."""
    was = jcompat.x64_enabled()
    jcompat.ensure_x64()
    yield
    jax.config.update("jax_enable_x64", was)


KAPPA = 1e6
RTOL = 1e-9
SIDES = ((jds, jev, jfi), (tds, tev, tfi))


@pytest.fixture(params=["0", "1"], ids=["plain", "validated"])
def validate_mode(request, monkeypatch):
    """Run a test both plain and under REPRO_VALIDATE=1."""
    monkeypatch.setenv("REPRO_VALIDATE", request.param)
    return request.param


def _overlay(net, m, seed=0):
    und = net.roofnet_like(seed=seed)
    return net.build_overlay(und, net.lowest_degree_nodes(und, m))


@pytest.fixture(scope="module")
def overlays():
    """(reference, port) overlays of the service: roofnet_like(seed=0),
    its 8 lowest-degree nodes."""
    return _overlay(jnet, 8), _overlay(tnet, 8)


@pytest.fixture(scope="module")
def overlays10():
    return _overlay(jnet, 10), _overlay(tnet, 10)


def _scaled_reference(overlay, scale):
    """Ground truth for a capacity-only change: the paths stay pinned and
    only capacities move (the reference test's helper, over the port)."""
    und = overlay.underlay.with_scaled_capacities(scale)
    return tcat.compute_categories(
        OverlayNetwork(underlay=und, agents=overlay.agents,
                       paths=overlay.paths)
    )


def _assert_cats_bitwise(a, b):
    assert list(a.capacity.keys()) == list(b.capacity.keys())
    assert a.members == b.members
    for F in a.capacity:
        assert a.capacity[F] == b.capacity[F]
    assert a.edge_capacity == b.edge_capacity


def _assert_inc_bitwise(a, b):
    for f in ("capacity", "entry_link", "entry_cat", "entry_coef",
              "link_ptr"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _services(overlays, engine="batched", clock=False, plan=None, **cfg):
    """The reference's and the port's service on the same overlay, config
    and (fresh) fault plan; the port's on the CPU with ``engine``."""
    cfg = {"design_iterations": 12, "drift_band": 0.0, **cfg}
    out = []
    for (ds, _, fi), ov in zip(SIDES, overlays):
        kw = {"config": ds.ServiceConfig(
            **cfg, engine=engine if ds is tds else "batched")}
        if clock:
            kw["clock"] = ds.VirtualClock()
        if plan is not None:
            kw["fault_injector"] = fi.FaultInjector(fi.FaultPlan(**plan))
        if ds is tds:
            kw["device"] = "cpu"
        out.append(ds.DesignService(ov, kappa=KAPPA, **kw))
    return out


def _port_event(ev):
    """A reference event as the port's event of the same fields."""
    cls = getattr(tev, type(ev).__name__, None)
    if cls is None:
        return ev
    return cls(**{f.name: getattr(ev, f.name)
                  for f in dataclasses.fields(ev)})


def _close(a, b, exact):
    if exact:
        return a == b or (np.isnan(a) and np.isnan(b))
    return a == pytest.approx(b, rel=RTOL, nan_ok=True)


def _assert_records(jrecs, trecs, exact=True):
    assert len(jrecs) == len(trecs)
    for j, t in zip(jrecs, trecs):
        for f in ("seq", "time", "event", "decision", "tier", "retries",
                  "faults"):
            assert getattr(t, f) == getattr(j, f), (f, j, t)
        assert _close(t.tau, j.tau, exact), (j, t)
        if exact:
            assert t.detail == j.detail


def _assert_state(js, ts, exact=True):
    assert ts.members == js.members
    assert ts.num_agents == js.num_agents
    assert ts.epoch == js.epoch
    assert ts.quarantined == js.quarantined
    assert ts.clock.now() == js.clock.now()
    assert_same(js.design, ts.design)
    assert _close(ts.tau, js.tau, exact)
    _assert_cats_bitwise(js.categories, ts.categories)
    _assert_inc_bitwise(js._inc, ts._inc)


def _run_both(jsvc, tsvc, events, exact=True):
    jrecs = [jsvc.process(ev) for ev in events]
    trecs = [tsvc.process(_port_event(ev)) for ev in events]
    _assert_records(jrecs, trecs, exact)
    _assert_state(jsvc, tsvc, exact)
    return trecs


def _worst(svc, n=3):
    return sorted(svc._binc.edges)[:n]


def _free_node(ov):
    return next(n for n in sorted(ov.underlay.graph.nodes)
                if n not in set(ov.agents))


# ---------------------------------------------------------------------------
# Patch vs recompile, bitwise (plain AND REPRO_VALIDATE=1)
# ---------------------------------------------------------------------------


def _patch_case(ov, jov, rng, links):
    k = int(rng.integers(1, min(len(links), 8) + 1))
    picked = [links[i] for i in
              sorted(rng.choice(len(links), size=k, replace=False).tolist())]
    return {e: float(s) for e, s in
            zip(picked, rng.uniform(0.1, 3.0, size=k))}


def _patch_both(jov, tov, und_scale):
    out = []
    for cat, ov in ((jcat, jov), (tcat, tov)):
        cats = cat.compute_categories(ov)
        inc = cat.compile_category_incidence(cats, ov.num_agents, KAPPA)
        changed = {
            d: ov.underlay.capacity(*d) * s
            for (u, v), s in und_scale.items()
            for d in ((u, v), (v, u))
            if d in cats.edge_capacity
        }
        patched, touched = cat.patch_categories_capacity(
            cats, changed, cat.edge_category_index(cats))
        out.append((cats, patched, touched,
                    cat.patch_category_incidence(inc, patched, touched)))
    return out


@pytest.mark.parametrize("case", range(6))
def test_patch_matches_recompile_bitwise(overlays10, validate_mode, case):
    jov, tov = overlays10
    cats = tcat.compute_categories(tov)
    links = sorted({(u, v) if u < v else (v, u)
                    for u, v in cats.edge_capacity})
    und_scale = _patch_case(tov, jov, np.random.default_rng(
        100 * int(validate_mode) + case), links)
    (_, jp, jt, jinc), (tc, tp, tt, tinc) = _patch_both(jov, tov, und_scale)
    ref = _scaled_reference(tov, und_scale)
    _assert_cats_bitwise(tp, ref)
    _assert_inc_bitwise(
        tinc, tcat.compile_category_incidence(ref, tov.num_agents, KAPPA))
    assert tp.flat is tc.flat  # the flat payload is shared, not recomputed
    _assert_cats_bitwise(jp, tp)
    assert np.array_equal(jt, tt)
    _assert_inc_bitwise(jinc, tinc)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_patch_property_random_subsets(seed):
    jov, tov = _overlay(jnet, 6, seed=1), _overlay(tnet, 6, seed=1)
    cats = tcat.compute_categories(tov)
    links = sorted({(u, v) if u < v else (v, u)
                    for u, v in cats.edge_capacity})
    und_scale = _patch_case(tov, jov, np.random.default_rng(seed), links)
    (_, jp, _, jinc), (_, tp, _, tinc) = _patch_both(jov, tov, und_scale)
    ref = _scaled_reference(tov, und_scale)
    _assert_cats_bitwise(tp, ref)
    _assert_inc_bitwise(tinc, tcat.compile_category_incidence(ref, 6, KAPPA))
    _assert_cats_bitwise(jp, tp)
    _assert_inc_bitwise(jinc, tinc)


def test_patch_rejects_unknown_and_nonpositive(overlays10):
    cats = tcat.compute_categories(overlays10[1])
    with pytest.raises(ValueError, match="not member edges"):
        tcat.patch_categories_capacity(cats, {(987, 986): 1.0})
    e = sorted(cats.edge_capacity)[0]
    with pytest.raises(ValueError, match="positive"):
        tcat.patch_categories_capacity(cats, {e: 0.0})


def test_branch_incidence_capacity_patch_matches_scratch(
        overlays10, validate_mode):
    """The patched ``BranchIncidence`` prices the in-flight round as a
    scratch compile does, on the numpy engine bitwise and on the torch
    engine (the patched capacities reach the device) at rtol 1e-9."""
    out = []
    for net, sim, ov in ((jnet, jsim, overlays10[0]),
                         (tnet, tsim, overlays10[1])):
        m = ov.num_agents
        cats = net.compute_categories(ov)
        f = jfmmd if net is jnet else fmmd
        design = f(m, 12, categories=cats, kappa=KAPPA, priority=True)
        sol = net.route_direct(
            net.demands_from_links(design.activated_links, KAPPA, m),
            cats, KAPPA)
        binc = sim.compile_incidence(sol, ov)
        picked = sorted({(u, v) if u < v else (v, u)
                         for u, v in binc.edges})[:4]
        changed = {d: ov.underlay.capacity(*d) * 0.35
                   for (u, v) in picked for d in ((u, v), (v, u))}
        patched = binc.with_capacities(changed)
        ref_ov = OverlayNetwork(
            underlay=ov.underlay.with_scaled_capacities(
                {e: 0.35 for e in picked}),
            agents=ov.agents, paths=ov.paths)
        assert np.array_equal(patched.base_capacity,
                              sim.compile_incidence(sol, ref_ov).base_capacity)
        makespan = sim.simulate(sol, ov, incidence=patched).makespan
        assert makespan == sim.simulate(sol, ref_ov).makespan
        out.append(makespan)
        if net is tnet:
            on_device = sim.simulate(sol, ov, incidence=patched,
                                     engine="torch", device="cpu")
            assert on_device.makespan == pytest.approx(makespan, rel=RTOL)
            assert on_device.makespan != pytest.approx(
                sim.simulate(sol, ov, incidence=binc).makespan, rel=1e-3)
            assert np.array_equal(
                binc.with_capacities({(991, 990): 5.0}).base_capacity,
                binc.base_capacity)
            with pytest.raises(ValueError, match="positive"):
                binc.with_capacities({picked[0]: 0.0})
            with pytest.raises(ValueError, match="vectorized"):
                sim.simulate(sol, ov, engine="reference", incidence=binc)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Warm-started FMMD-P
# ---------------------------------------------------------------------------


def test_warm_fmmd_bitwise_equals_cold_and_the_reference(overlays10):
    results = []
    for cat, ps, f, ov in ((jcat, JPriorityState, jfmmd, overlays10[0]),
                           (tcat, _PriorityState, fmmd, overlays10[1])):
        m = ov.num_agents
        cats = cat.compute_categories(ov)
        inc = cat.compile_category_incidence(cats, m, KAPPA)
        atoms = [(i, j) for i in range(m) for j in range(i + 1, m)]
        state = ps(atoms, m, cats, KAPPA, incidence=inc)
        f(m, 8, categories=cats, kappa=KAPPA, priority=True, incidence=inc,
          warm_state=state)
        e = sorted(cats.edge_capacity)[0]
        patched, touched = cat.patch_categories_capacity(
            cats, {e: cats.edge_capacity[e] * 0.3})
        pinc = cat.patch_category_incidence(inc, patched, touched)
        state.reset(pinc)
        warm = f(m, 10, categories=patched, kappa=KAPPA, priority=True,
                 incidence=pinc, warm_state=state)
        cold = f(m, 10, categories=patched, kappa=KAPPA, priority=True,
                 incidence=pinc)
        assert np.array_equal(warm.matrix, cold.matrix)
        assert warm.activated_links == cold.activated_links
        assert warm.rho == cold.rho
        results.append(warm)
    assert np.array_equal(results[0].matrix, results[1].matrix)
    assert tuple(map(tuple, results[0].activated_links)) == \
        results[1].activated_links
    assert results[0].rho == results[1].rho


def test_warm_state_validation(overlays10):
    ov = overlays10[1]
    m = ov.num_agents
    cats = tcat.compute_categories(ov)
    inc = tcat.compile_category_incidence(cats, m, KAPPA)
    atoms = [(i, j) for i in range(m) for j in range(i + 1, m)]
    state = _PriorityState(atoms, m, cats, KAPPA, incidence=inc)
    with pytest.raises(ValueError, match="atoms"):
        fmmd(m, 4, categories=cats, kappa=KAPPA, priority=True,
             allowed_links=[(0, 1)], warm_state=state)
    with pytest.raises(ValueError, match="does not match"):
        fmmd(m, 4, categories=cats, kappa=2.0, priority=True,
             warm_state=state)
    with pytest.raises(ValueError, match="capacity-only"):
        state.reset(tcat.compile_category_incidence(cats, m, 2.0))


# ---------------------------------------------------------------------------
# Event sourcing
# ---------------------------------------------------------------------------


def _sto(net):
    und = net.roofnet_like(seed=0)
    edges = sorted(und.graph.edges)[:6]
    return net.StochasticScenario(
        links=(
            net.MarkovLinkModel(edges=tuple(edges[:3]), scales=(1.0, 0.3),
                                transition=((0.6, 0.4), (0.5, 0.5))),
            net.MarkovLinkModel(edges=tuple(edges[3:]), scales=(1.0, 0.5),
                                transition=((0.7, 0.3), (0.6, 0.4))),
        ),
        horizon=40.0, step=5.0, churn_hazard=0.02, churn_agents=(1, 3),
    )


@pytest.mark.parametrize("key", [5, 6, (3, 1)])
def test_events_from_stochastic_is_the_reference(key):
    jsto, tsto = _sto(jnet), _sto(tnet)
    a = jev.events_from_stochastic(jsto, key)
    b = tev.events_from_stochastic(tsto, key)
    assert b == tev.events_from_stochastic(tsto, key)
    assert [_port_event(e) for e in a] == list(b)
    times = [e.time for e in b]
    assert times == sorted(times)
    prev = {}
    for _, changed in realization_deltas(tsto.sample(key)):
        assert changed
        for e, s in changed.items():
            assert s != prev.get(e, 1.0)
        prev.update(changed)


def test_realization_deltas_rejects_scalar_phase():
    with pytest.raises(ValueError, match="per-edge"):
        realization_deltas(tsim.Scenario(
            capacity_phases=(tsim.CapacityPhase(1.0, 0.5),)))
    deltas = realization_deltas(tsim.Scenario(capacity_phases=(
        tsim.CapacityPhase(1.0, {(0, 1): 0.5}), tsim.CapacityPhase(2.0, 1.0),
    )))
    assert deltas == ((1.0, {(0, 1): 0.5}), (2.0, {(0, 1): 1.0}))


MALFORMED = [
    ("LinkStateChange", (1.0, {(0, 1): 0.5})),
    ("LinkStateChange", (1.0, {(0, 1): -0.5})),
    ("LinkStateChange", (float("nan"), {})),
    ("LinkStateChange", (1.0, {(0, 1, 2): 0.5})),
    ("LinkStateChange", (1.0, [1, 2])),
    ("LinkStateChange", (-1.0, {})),
    ("AgentLeave", (1.0, -1)),
    ("AgentLeave", (1.0, True)),
    ("AgentLeave", (2.0, 3)),
    ("AgentJoin", (1.0, 2)),
    ("AgentJoin", (1.0, 2.5)),
]


def test_malformed_reason_is_the_reference():
    for kind, args in MALFORMED:
        a = jev.malformed_reason(getattr(jev, kind)(*args))
        b = tev.malformed_reason(getattr(tev, kind)(*args))
        assert a == b, (kind, args)
        assert tev.event_sort_key(getattr(tev, kind)(*args)) == \
            jev.event_sort_key(getattr(jev, kind)(*args))
    assert tev.malformed_reason(object()) is not None


# ---------------------------------------------------------------------------
# The service loop
# ---------------------------------------------------------------------------


def test_initial_design_is_the_reference(overlays):
    jsvc, tsvc = _services(overlays)
    _assert_state(jsvc, tsvc)
    assert tsvc.tau == 16.0
    mixing.validate_mixing(tsvc.design)


def test_absorb_untraversed_edge_is_noop(overlays):
    jsvc, tsvc = _services(overlays)
    member = tsvc.categories.edge_capacity
    free = next((u, v) for u, v in sorted(overlays[1].underlay.graph.edges)
                if (u, v) not in member and (v, u) not in member)
    inc_before, tau_before = tsvc._inc, tsvc.tau
    rec = _run_both(jsvc, tsvc, [
        jev.LinkStateChange(time=1.0, scales={free: 0.01}),
        jev.LinkStateChange(time=2.0, scales={free: 0.01}),
    ])
    assert [r.decision for r in rec] == ["absorb", "absorb"]
    assert tsvc._inc is inc_before  # nothing recompiled, provably no-op
    assert tsvc.tau == tau_before


@pytest.mark.parametrize("engine", ["batched", "torch"])
def test_adopt_and_defer_follow_transition_pricing(overlays, engine):
    exact = engine == "batched"
    jsvc, tsvc = _services(overlays, engine,
                           horizon_rounds=1000.0, transition_rounds=0.0)
    scales = {e: 0.25 for e in _worst(tsvc)}
    rec = _run_both(jsvc, tsvc, [jev.LinkStateChange(1.0, scales)], exact)
    assert rec[0].decision == "adopt"
    assert tsvc.tau < 0.9 * 32.0
    jsvc2, tsvc2 = _services(overlays, engine,
                             horizon_rounds=0.0, transition_rounds=1.0)
    rec2 = _run_both(jsvc2, tsvc2, [jev.LinkStateChange(1.0, scales)], exact)
    assert rec2[0].decision == "defer"
    assert tsvc2.tau > tsvc.tau


def test_patch_keeps_incumbent_within_band(overlays):
    jsvc, tsvc = _services(overlays, drift_band=10.0)
    e = sorted(tsvc.categories.edge_capacity)[0]
    key = (e[0], e[1]) if e[0] < e[1] else (e[1], e[0])
    w_before = tsvc.design
    rec = _run_both(jsvc, tsvc, [jev.LinkStateChange(1.0, {key: 0.5})])
    assert rec[0].decision in ("patch", "absorb")
    assert tsvc.design is w_before
    _assert_cats_bitwise(tsvc.categories,
                         _scaled_reference(tsvc._overlay, {key: 0.5}))


def test_leave_and_join_regroup_bitwise(overlays, validate_mode):
    jsvc, tsvc = _services(overlays)
    rec = _run_both(jsvc, tsvc, [
        jev.AgentLeave(time=1.0, agent=3),
        jev.AgentJoin(time=2.0, node=_free_node(overlays[1])),
    ])
    assert [r.decision for r in rec] == ["redesign", "redesign"]
    assert tsvc.members == (0, 1, 2, 4, 5, 6, 7, 8)
    ref_ov = tnet.build_overlay(
        overlays[1].underlay, [tsvc._node_of[h] for h in tsvc.members])
    ref = tcat.compute_categories(ref_ov)
    _assert_cats_bitwise(tsvc.categories, ref)
    _assert_inc_bitwise(
        tsvc._inc, tcat.compile_category_incidence(ref, 8, KAPPA))
    mixing.validate_mixing(tsvc.design)


def test_single_survivor(overlays):
    pair = tuple(
        ov.__class__(underlay=ov.underlay, agents=ov.agents[:2],
                     paths={(0, 1): ov.path(0, 1)})
        for ov in overlays)
    jsvc, tsvc = _services(pair, design_iterations=4)
    rec = _run_both(jsvc, tsvc, [jev.AgentLeave(time=1.0, agent=0),
                                 jev.AgentLeave(time=2.0, agent=1)])
    assert rec[0].decision == "redesign"
    assert "single survivor" in rec[0].detail
    assert tsvc.design.shape == (1, 1) and tsvc.design[0, 0] == 1.0
    assert tsvc.tau == 0.0
    assert rec[1].decision == "reject"
    assert tsvc.members == (1,)


# ---------------------------------------------------------------------------
# Fault injection and degradation tiers (ServiceLog decision trail)
# ---------------------------------------------------------------------------


def test_incumbent_keep_after_retries_with_backoff(overlays):
    jsvc, tsvc = _services(overlays, clock=True,
                           plan=dict(seed=0, rate=1.0, modes=("raise",)))
    w_before = tsvc.design
    scales = {e: 0.25 for e in _worst(tsvc)}
    rec = _run_both(jsvc, tsvc, [jev.LinkStateChange(3.0, scales)])
    assert rec[0].decision == rec[0].tier == "incumbent-keep"
    assert rec[0].retries == 2 and len(rec[0].faults) == 3
    assert tsvc.design is w_before
    assert tsvc.clock.now() == pytest.approx(4.5)  # 0.5 + 1.0 after t = 3
    assert tsvc.tau > 16.0
    assert tsvc.injector.injected == jsvc.injector.injected


def test_timeout_faults_advance_virtual_clock(overlays):
    jsvc, tsvc = _services(
        overlays, clock=True, max_retries=1,
        plan=dict(seed=0, rate=1.0, modes=("timeout",), timeout_seconds=2.0))
    scales = {e: 0.25 for e in _worst(tsvc)}
    rec = _run_both(jsvc, tsvc, [jev.LinkStateChange(0.0, scales)])
    assert rec[0].decision == "incumbent-keep"
    assert [m for _, m in tsvc.injector.injected] == ["timeout", "timeout"]
    assert tsvc.clock.now() == pytest.approx(4.5)


def test_stale_candidate_detected_by_epoch(overlays):
    jsvc, tsvc = _services(overlays, max_retries=0)
    for svc, fi in ((jsvc, jfi), (tsvc, tfi)):
        stale = svc._priced_candidate()
        inj = fi.FaultInjector(fi.FaultPlan(seed=0, rate=1.0,
                                            modes=("stale",)))
        inj._last_good, inj._has_last = stale, True
        inj._clock = svc.clock
        svc.injector = inj
    scales = {e: 0.25 for e in _worst(tsvc)}
    rec = _run_both(jsvc, tsvc, [jev.LinkStateChange(1.0, scales)])
    assert rec[0].decision == "incumbent-keep"
    assert "stale candidate" in rec[0].faults[0]


def test_nan_poison_detected_and_retried(overlays):
    jsvc, tsvc = _services(overlays, max_retries=1,
                           plan=dict(seed=3, rate=1.0, modes=("nan",)))
    scales = {e: 0.25 for e in _worst(tsvc)}
    rec = _run_both(jsvc, tsvc, [jev.LinkStateChange(1.0, scales)])
    assert rec[0].decision == "incumbent-keep"
    assert all("poisoned" in f for f in rec[0].faults)


def test_contract_violation_falls_back_to_scratch_rebuild(
        overlays, monkeypatch):
    jsvc, tsvc = _services(overlays)
    for ds, cv in ((jds, JContractViolation), (tds, ContractViolation)):
        def tripped(*a, cv=cv, **k):
            raise cv("CategoryIncidence", "entry_coef", "finite", "poisoned")
        monkeypatch.setattr(ds, "patch_category_incidence", tripped)
    e = sorted(tsvc.categories.edge_capacity)[0]
    key = (e[0], e[1]) if e[0] < e[1] else (e[1], e[0])
    rec = _run_both(jsvc, tsvc, [jev.LinkStateChange(1.0, {key: 0.5})])
    assert rec[0].decision == rec[0].tier == "scratch-rebuild"
    monkeypatch.undo()
    _assert_cats_bitwise(tsvc.categories,
                         _scaled_reference(tsvc._overlay, {key: 0.5}))
    mixing.validate_mixing(tsvc.design)


def test_other_exceptions_are_not_caught(overlays, monkeypatch):
    """Only the service's own exception types degrade; anything else (a
    failed launch among them) reaches the caller."""
    _, tsvc = _services(overlays)

    def broken(*a, **k):
        raise RuntimeError("not a pricing fault")

    monkeypatch.setattr(tds, "patch_category_incidence", broken)
    e = sorted(tsvc.categories.edge_capacity)[0]
    with pytest.raises(RuntimeError, match="not a pricing fault"):
        tsvc.process(tev.LinkStateChange(1.0, {e: 0.5}))


def test_leave_fallback_renormalizes_incumbent(overlays):
    jsvc, tsvc = _services(overlays, max_retries=0,
                           plan=dict(seed=0, rate=1.0, modes=("raise",)))
    w_before = tsvc.design
    rec = _run_both(jsvc, tsvc, [jev.AgentLeave(time=1.0, agent=2)])
    assert rec[0].decision == rec[0].tier == "incumbent-keep"
    assert "renormalized" in rec[0].detail
    assert tsvc.num_agents == 7
    keep = [0, 1, 3, 4, 5, 6, 7]
    off = w_before[np.ix_(keep, keep)] * (1 - np.eye(7))
    np.testing.assert_array_equal(tsvc.design * (1 - np.eye(7)), off)
    mixing.validate_mixing(tsvc.design)


def test_join_fallback_reverts_membership(overlays):
    jsvc, tsvc = _services(overlays, max_retries=0,
                           plan=dict(seed=0, rate=1.0, modes=("raise",)))
    members, w, epoch = tsvc.members, tsvc.design, tsvc.epoch
    rec = _run_both(jsvc, tsvc, [
        jev.AgentJoin(time=1.0, node=_free_node(overlays[1])),
        jev.AgentJoin(time=2.0, node=overlays[1].agents[0]),
        jev.AgentJoin(time=3.0, node=987654),
    ])
    assert rec[0].decision == "incumbent-keep"
    assert "reverted" in rec[0].detail
    assert [r.decision for r in rec[1:]] == ["reject", "reject"]
    assert tsvc.members == members
    assert tsvc.design is w
    assert tsvc.epoch > epoch


def test_quarantine_then_drop(overlays):
    jsvc, tsvc = _services(overlays)
    rec = _run_both(jsvc, tsvc, [
        jev.LinkStateChange(time=1.0, scales={(0, 1): -2.0}, origin=4),
        jev.LinkStateChange(time=2.0, scales={}, origin=4),
        jev.AgentLeave(time=3.0, agent=99),
        jev.LinkStateChange(time=4.0, scales={(9876, 9875): 0.5}, origin=5),
        jev.LinkStateChange(time=5.0, scales={(9876, 9875): 0.5}),
        jev.AgentLeave(time=6.0, agent=77, origin=6),
    ])
    assert [r.decision for r in rec] == [
        "quarantine", "drop", "reject", "quarantine", "reject", "quarantine"]
    assert all(r.tier == "quarantine" for r in rec)
    assert tsvc.quarantined == (4, 5, 6)
    assert tsvc.members == tuple(range(8))


@pytest.mark.parametrize("engine", ["batched", "torch"])
def test_event_stream_zero_drops_and_replayable(overlays, engine):
    """A mixed malformed/chaotic stream: every event gets exactly one
    record, a replay reproduces the trail, and it is the reference's."""
    exact = engine == "batched"

    def stream(svc):
        member = sorted(svc.categories.edge_capacity)
        events = [
            jev.LinkStateChange(
                time=float(k),
                scales={member[(3 * k) % len(member)]: 0.3 + 0.05 * k})
            for k in range(8)
        ]
        events.insert(3, jev.LinkStateChange(time=2.5, scales={(0, 1): -1.0},
                                             origin=2))
        events.append(jev.AgentLeave(time=9.0, agent=1))
        return events

    trails = []
    for _ in range(2):
        jsvc, tsvc = _services(overlays, engine, plan=dict(seed=11, rate=0.5))
        events = stream(tsvc)
        jlog = jsvc.run(events)
        tlog = tsvc.run([_port_event(e) for e in events])
        assert len(tlog) == len(events)
        _assert_records(list(jlog), list(tlog), exact)
        assert tlog.decisions == jlog.decisions
        assert tlog.tiers == jlog.tiers
        assert tlog.fault_count == jlog.fault_count
        trails.append([(r.event, r.decision, r.tier, r.tau) for r in tlog])
    assert trails[0] == trails[1]


def _example_events(svc, ov):
    worst = _worst(svc)
    return [
        jev.LinkStateChange(time=1.0, scales={e: 0.3 for e in worst}),
        jev.AgentLeave(time=2.0, agent=1),
        jev.AgentLeave(time=3.0, agent=5),
        jev.AgentJoin(time=4.0, node=_free_node(ov)),
        jev.LinkStateChange(time=5.0, scales={e: 1.0 for e in worst}),
    ]


def test_example_stream_on_the_torch_engine(overlays, monkeypatch):
    """``examples/elastic_failover.py``'s stream, the outage at t = 2: the
    port's torch engine on the CPU against the reference's batched one —
    the same trail, every pricing call's makespan at rtol 1e-9, and the
    leave transitions on "batched" whatever the engine."""
    jsvc, tsvc = _services(overlays, "torch", drift_band=0.05)
    priced = {jds: [], tds: []}
    for ds in priced:
        sim = ds.simulate

        def recorded(*a, ds=ds, sim=sim, **k):
            res = sim(*a, **k)
            priced[ds].append((k.get("engine", "batched"), res.makespan))
            return res

        monkeypatch.setattr(ds, "simulate", recorded)
    for ev in _example_events(tsvc, overlays[1]):
        if ev.time == 2.0:
            for svc, fi in ((jsvc, jfi), (tsvc, tfi)):
                svc.injector = fi.FaultInjector(
                    fi.FaultPlan(seed=0, rate=1.0, modes=("raise",)),
                    clock=svc.clock)
        _run_both(jsvc, tsvc, [ev], exact=False)
        jsvc.injector = tsvc.injector = None
    assert [r.decision for r in tsvc.log] == [
        "adopt", "incumbent-keep", "redesign", "redesign", "adopt"]
    assert [t for t in (16.0, 16.0, 32.0, 26.666666666666668, 16.0)] == \
        pytest.approx([r.tau for r in tsvc.log], rel=RTOL)
    assert len(priced[tds]) == len(priced[jds]) == 7
    engines = [e for e, _ in priced[tds]]
    assert engines == ["torch", "batched", "batched", "torch", "torch",
                       "torch", "torch"]
    for (_, a), (_, b) in zip(priced[jds], priced[tds]):
        assert b == pytest.approx(a, rel=RTOL)


def test_service_config_validation():
    with pytest.raises(ValueError, match="drift_band"):
        tds.ServiceConfig(drift_band=-0.1)
    with pytest.raises(ValueError, match="backoff"):
        tds.ServiceConfig(backoff_factor=0.5)
    with pytest.raises(ValueError, match="max_retries"):
        tds.ServiceConfig(max_retries=-1)
    with pytest.raises(ValueError, match="unknown pricing engine"):
        tds.ServiceConfig(engine="jax")
    assert tds.ServiceConfig().engine == "batched"
    assert tds.ServiceConfig(engine="torch").engine == "torch"
    clock = tds.VirtualClock()
    with pytest.raises(ValueError, match="backwards"):
        clock.advance(-1.0)
    clock.advance_to(3.0)
    clock.advance_to(1.0)
    assert clock.now() == 3.0


def test_device_none_means_cuda(overlays):
    if torch.cuda.is_available():
        svc = tds.DesignService(overlays[1], kappa=KAPPA)
        assert svc.device.type == "cuda"
        return
    with pytest.raises(compat.NoCudaDeviceError):
        tds.DesignService(overlays[1], kappa=KAPPA)
