"""The port's own copies of the host network modules (``repro_torch.net``:
topology with its networkx-free ``Graph``, demands, categories, routing,
the numpy simulator engines, the stochastic layer) return bitwise what the
JAX package's ``repro.net`` returns, instance by instance from the same
seeds: nodes, edges in iteration order, capacities, every agent pair's
path, categories, incidences, routing trees, makespans and realizations."""

import numpy as np
import pytest

import repro.net as jnet
import repro_torch.net as tnet
from _torch_net import (
    assert_same,
    both,
    line_instance,
    random_instance,
    stochastic_for,
)
from repro.net import routing as jrouting
from repro_torch.net import routing as trouting

SEEDS = range(8)


def _graph_view(g):
    """Everything order-dependent a graph exposes, as plain values."""
    return (
        list(g.nodes),
        [(n, dict(g.nodes[n])) for n in g.nodes],
        [(u, v, dict(d)) for u, v, d in g.edges(data=True)],
        [(n, list(g.adj[n])) for n in g.nodes],
        list(g.degree),
        g.number_of_nodes(),
        g.number_of_edges(),
    )


GENERATORS = (
    [(f"roofnet-{s}", "roofnet_like", dict(seed=s)) for s in SEEDS]
    + [(f"roofnet-small-{s}", "roofnet_like",
        dict(seed=s, num_nodes=16, num_links=30)) for s in SEEDS]
    + [(f"geometric-{s}", "random_geometric_underlay",
        dict(n=12, radius=0.5, seed=s)) for s in SEEDS]
    + [(f"geometric-sparse-{s}", "random_geometric_underlay",
        dict(n=25, radius=0.3, seed=s)) for s in SEEDS]
    + [(f"grid-{r}x{c}", "grid_underlay", dict(rows=r, cols=c))
       for r, c in ((1, 4), (2, 3), (3, 4), (4, 4), (5, 2))]
    + [(f"line-{n}", "line_underlay", dict(n=n)) for n in (2, 5, 9)]
    + [(f"dumbbell-{a}-{b}", "dumbbell_underlay", dict(left=a, right=b))
       for a, b in ((2, 2), (3, 1), (4, 3))]
    + [(f"torus-{x}x{y}", "ici_torus_underlay", dict(x=x, y=y))
       for x, y in ((3, 3), (2, 4), (4, 5))]
)


def _agents(net, u, name):
    if name.startswith("roofnet"):
        return net.lowest_degree_nodes(u, 10)
    return list(u.graph.nodes)[: min(8, u.num_nodes)]


@pytest.mark.parametrize(
    "name,gen,kwargs", GENERATORS, ids=[g[0] for g in GENERATORS]
)
def test_generators_and_paths_bitwise(name, gen, kwargs):
    ju, tu = (getattr(net, gen)(**kwargs) for net in (jnet, tnet))
    assert _graph_view(ju.graph) == _graph_view(tu.graph)
    assert ju.directed_capacities() == tu.directed_capacities()
    ja, ta = _agents(jnet, ju, name), _agents(tnet, tu, name)
    assert ja == ta
    for method in ("pairwise", "bfs"):
        jo = jnet.build_overlay(ju, ja, method=method)
        to = tnet.build_overlay(tu, ta, method=method)
        assert list(jo.paths.items()) == list(to.paths.items()), method
        for jx, tx in zip(jo.batched_path_edges(), to.batched_path_edges()):
            assert_same(jx, tx)
        pairs = jo.overlay_links
        assert jnet.mid_path_edges(jo, pairs) == tnet.mid_path_edges(to, pairs)
    # every node pair, not only the agents: the bidirectional BFS's tie
    # order is what decides which equal-length path comes out
    nodes = list(ju.graph.nodes)[:12]
    for s in nodes:
        for t in nodes:
            assert ju.shortest_path(s, t) == tu.shortest_path(s, t)


@pytest.mark.parametrize("seed", SEEDS)
def test_scaled_capacities_and_copy_keep_order(seed):
    ju, tu = both(lambda net: net.roofnet_like(seed=seed))
    edges = list(ju.graph.edges)
    scale = {e: 0.5 + 0.1 * (k % 7) for k, e in enumerate(edges[::5])}
    for s in (0.25, scale):
        assert _graph_view(ju.with_scaled_capacities(s).graph) == _graph_view(
            tu.with_scaled_capacities(s).graph)


def test_graph_edge_reinsertion_moves_to_the_end():
    """remove_edge + add_edge puts the edge last in both adjacency rows,
    and re-adding an existing edge keeps its place — roofnet_like's trim
    relies on both."""
    import networkx as nx

    ops = [("add", 0, 1), ("add", 1, 2), ("add", 0, 2), ("add", 2, 3),
           ("remove", 0, 1), ("add", 0, 1), ("add", 1, 2)]
    gs = (nx.Graph(), tnet.topology.Graph())
    for g in gs:
        for op, u, v in ops:
            if op == "add":
                g.add_edge(u, v, capacity=float(u + v))
            else:
                g.remove_edge(u, v)
    assert _graph_view(gs[0]) == _graph_view(gs[1])
    assert _graph_view(gs[0].copy()) == _graph_view(gs[1].copy())
    assert _graph_view(nx.Graph(gs[0])) == _graph_view(
        tnet.topology.Graph(gs[1]))
    assert [sorted(c) for c in nx.connected_components(gs[0])] == [
        sorted(c) for c in tnet.topology.connected_components(gs[1])]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("relay", [False, True], ids=["direct", "relay"])
def test_categories_incidence_and_routing_bitwise(seed, relay):
    (js, jo), (ts, to) = both(random_instance, seed, 3 + seed % 5, relay)
    assert js.demands == tuple(
        jnet.MulticastDemand(d.source, d.destinations, d.size)
        for d in ts.demands
    )
    assert js.trees == ts.trees
    assert js.completion_time == ts.completion_time
    assert js.method == ts.method
    jc, tc = jnet.compute_categories(jo), tnet.compute_categories(to)
    assert_same(jc, tc, "categories")
    m = jo.num_agents
    assert_same(
        jnet.compile_category_incidence(jc, m, 1e6),
        tnet.compile_category_incidence(tc, m, 1e6), "category incidence",
    )
    assert_same(
        jnet.compile_incidence(js, jo), tnet.compile_incidence(ts, to),
        "branch incidence",
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_roofnet_paper_instance_bitwise(seed):
    """The paper's instance: roofnet_like, the 10 lowest-degree agents,
    categories, a ring's direct routing and its congestion-aware
    re-routing."""
    def build(net):
        u = net.roofnet_like(seed=seed)
        ov = net.build_overlay(u, net.lowest_degree_nodes(u, 10))
        cats = net.compute_categories(ov)
        links = [(i, (i + 1) % 10) for i in range(10)]
        links = sorted({(min(a, b), max(a, b)) for a, b in links})
        demands = net.demands_from_links(links, net.PAPER_MODEL_BYTES, 10)
        direct = net.route_direct(demands, cats, net.PAPER_MODEL_BYTES)
        aware = net.route_congestion_aware(
            demands, cats, net.PAPER_MODEL_BYTES, 10, rounds=2)
        return ov, cats, direct, aware

    (jo, jc, jd, ja), (to, tc, td, ta) = both(build)
    assert list(jo.paths.items()) == list(to.paths.items())
    assert_same(jc, tc, "categories")
    for j, t in ((jd, td), (ja, ta)):
        assert j.trees == t.trees and j.completion_time == t.completion_time
        assert_same(
            jnet.simulate(j, jo), tnet.simulate(t, to), "simulate")


def test_route_milp_bitwise():
    """The MILP (scipy, imported on use) gives the same trees and τ."""
    def build(net):
        u = net.dumbbell_underlay(3, 3)
        ov = net.build_overlay(u, list(range(6)))
        cats = net.compute_categories(ov)
        demands = net.demands_from_links([(0, 3), (1, 4), (2, 5), (0, 1)],
                                         1e6, 6)
        return net.route_milp(demands, cats, 1e6, 6, time_limit=30.0)

    j, t = both(build)
    assert j.trees == t.trees
    assert j.completion_time == t.completion_time
    assert j.method == t.method


def _scenario(net, tau, m, seed):
    rng = np.random.default_rng(seed + 7)
    return net.Scenario(
        capacity_phases=(
            net.CapacityPhase(start=0.3 * tau, scale=0.5),
            net.CapacityPhase(start=0.9 * tau, scale=1.5),
        ),
        cross_traffic=(
            net.CrossTraffic(src=0, dst=1, rate=20_000.0, start=0.1 * tau,
                             stop=0.6 * tau),
        ),
        stragglers=(
            net.StragglerEvent(agent=m - 1, slowdown=2.0, start=0.2 * tau,
                               stop=0.7 * tau),
        ),
        churn=(
            (net.ChurnEvent(agent=int(rng.integers(m)), time=0.5 * tau),)
            if rng.random() < 0.6 else ()
        ),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("engine", ["batched", "vectorized", "reference"])
@pytest.mark.parametrize("with_scenario", [False, True],
                         ids=["static", "scenario"])
def test_simulate_numpy_engines_bitwise(seed, engine, with_scenario):
    (js, jo), (ts, to) = both(random_instance, seed, 3 + seed % 4)
    tau = max(float(js.completion_time), 1.0)
    m = jo.num_agents
    jsc, tsc = (
        both(_scenario, tau, m, seed) if with_scenario else (None, None)
    )
    if engine == "reference" and with_scenario:
        for net, sol, ov, sc in ((jnet, js, jo, jsc), (tnet, ts, to, tsc)):
            with pytest.raises(ValueError, match="vectorized"):
                net.simulate(sol, ov, scenario=sc, engine=engine)
        return
    assert_same(
        jnet.simulate(js, jo, scenario=jsc, engine=engine),
        tnet.simulate(ts, to, scenario=tsc, engine=engine),
        "simulate",
    )


@pytest.mark.parametrize("seed", range(4))
def test_route_time_expanded_and_phased_bitwise(seed):
    (js, jo), (ts, to) = both(random_instance, seed, 4)
    tau = max(float(js.completion_time), 1.0)

    def phased(net, sol, ov):
        cats = net.compute_categories(ov)
        sc = net.Scenario(
            capacity_phases=(net.CapacityPhase(start=0.4 * tau, scale=0.5),)
        )
        ph = net.route_time_expanded(sol.demands, cats, sc, 1e6,
                                     ov.num_agents)
        return ph, net.simulate_phased(ph, ov, scenario=sc)

    jp, jr = phased(jnet, js, jo)
    tp, tr = phased(tnet, ts, to)
    assert jp.boundaries == tp.boundaries
    assert [s.trees for s in jp.solutions] == [s.trees for s in tp.solutions]
    assert_same(jr, tr, "simulate_phased")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("churn", [False, True], ids=["links", "churn"])
def test_stochastic_sample_many_and_densify_bitwise(seed, churn):
    (js, jo), (ts, to) = both(random_instance, seed, 5)
    tau = max(float(js.completion_time), 1.0)
    jsto = stochastic_for(jnet, jo, tau, churn=churn)
    tsto = stochastic_for(tnet, to, tau, churn=churn)
    assert_same(jsto.sample_many(seed, 6), tsto.sample_many(seed, 6),
                "sample_many")
    jb = jnet.stochastic.densify_realizations(
        jsto.sample_many(seed, 6), jnet.compile_incidence(js, jo))
    tb = tnet.stochastic.densify_realizations(
        tsto.sample_many(seed, 6), tnet.compile_incidence(ts, to))
    assert_same(jb, tb, "RealizationBatch")


@pytest.mark.parametrize(
    "engine", ["batched", "vectorized", "reference", "torch"])
def test_line_instance_hand_checkable(engine):
    """κ = 1e6 B over C = 125 kB/s: 8 s static, and halving C at t = 4 s
    doubles the remaining 4 s to 12 s."""
    sol, ov = line_instance(tnet)
    kw = {"device": "cpu"} if engine == "torch" else {}
    assert tnet.simulate(sol, ov, engine=engine, **kw).makespan == 8.0
    if engine == "reference":
        return
    sc = tnet.Scenario(capacity_phases=(tnet.CapacityPhase(4.0, 0.5),))
    assert tnet.simulate(
        sol, ov, scenario=sc, engine=engine, **kw).makespan == 12.0


def test_the_routing_copy_keeps_scipy_lazy():
    """``route_milp`` imports scipy inside the call, as the reference
    does (``routing.py``): the module names no scipy at import."""
    import inspect

    src = inspect.getsource(trouting)
    head = src[: src.index("def route_milp")]
    assert "import scipy" not in head and "from scipy" not in head
    assert inspect.getsource(trouting.route_milp).count(
        "from scipy") == inspect.getsource(jrouting.route_milp).count(
        "from scipy")


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_implementations_hold_the_fast_paths(seed):
    """The port's retained ground truths (registered in
    ``src/repro_torch/analysis/parity_manifest.txt``) against its fast
    paths, and each the JAX package's own reference: the dict-loop
    ``_route_congestion_aware_reference`` gives ``route_congestion_aware``'s
    trees, ``_compute_categories_reference`` its categories and
    ``_compile_category_incidence_reference`` ``compile_category_incidence``'s
    entry arrays, bitwise."""
    from repro.net import categories as jcats
    from repro_torch.net import categories as tcats

    m = 3 + seed % 5

    def build(net, cats_mod, routing_mod):
        u = net.random_geometric_underlay(12, radius=0.5, seed=seed)
        ov = net.build_overlay(u, list(u.graph.nodes)[:m])
        rng = np.random.default_rng(seed)
        links = [(i, j) for i in range(m) for j in range(i + 1, m)
                 if rng.random() < 0.6] or [(0, 1)]
        demands = net.demands_from_links(links, 1e6, m)
        fast_cats = net.compute_categories(ov)
        ref_cats = cats_mod._compute_categories_reference(ov)
        return (
            fast_cats, ref_cats,
            net.compile_category_incidence(fast_cats, m, 1e6),
            cats_mod._compile_category_incidence_reference(ref_cats, m, 1e6),
            net.route_congestion_aware(demands, fast_cats, 1e6, m, rounds=2),
            routing_mod._route_congestion_aware_reference(
                demands, fast_cats, 1e6, m, rounds=2),
        )

    jax_side = build(jnet, jcats, jrouting)
    port = build(tnet, tcats, trouting)
    fast_cats, ref_cats, fast_inc, ref_inc, fast_sol, ref_sol = port
    for what in ("members", "capacity", "edge_capacity"):
        assert list(getattr(fast_cats, what).items()) == list(
            getattr(ref_cats, what).items()), what
    for name in ("capacity", "entry_link", "entry_cat", "entry_coef",
                 "link_ptr"):
        a, b = getattr(fast_inc, name), getattr(ref_inc, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert fast_sol.trees == ref_sol.trees
    assert fast_sol.completion_time == ref_sol.completion_time
    assert_same(jax_side[1], ref_cats, "reference categories")
    assert_same(jax_side[3], ref_inc, "reference incidence")
    assert jax_side[5].trees == ref_sol.trees
    assert jax_side[5].completion_time == ref_sol.completion_time
