"""The port's designer (``repro_torch.core``: mixing helpers, weight_opt,
fmmd, sca, topology_baselines, designer) against the JAX package's.

The host numpy pieces are held bitwise. The weight optimization is torch
float64 autograd and the reference's Adam trajectory is chaotic in the
last bit, so the port is held in two halves: the Adam step teacher-forced
along the reference's own run (rtol 1e-10), and the host logic with the
optimiser recorded (``_torch_design.RecordedOptimiser``), bitwise. The
unpatched port must still reproduce the supports and τ whose design does
not depend on where Adam ends. ``repro.compat.ensure_x64()`` is called
before any JAX designer runs: the reference's designs depend on the flag.
"""

import importlib
import random

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.net as jnet
import repro_torch.core as tcore
import repro_torch.net as tnet
from repro import compat as jcompat
from repro.core import mixing as jmix
from repro.core import weight_opt as jwo
from repro_torch.core import mixing as tmix
from repro_torch.core import weight_opt as two
from repro_torch.net.topology import Graph, minimum_spanning_tree

from _torch_design import (
    RecordedOptimiser,
    assert_same_design,
    assert_same_outcome,
)

jfmmd = importlib.import_module("repro.core.fmmd")
tfmmd = importlib.import_module("repro_torch.core.fmmd")

M = 10
SCHEMES = ("clique", "ring", "prim", "fmmd-wp", "sca")


def _paper(net):
    u = net.roofnet_like(seed=0)
    ov = net.build_overlay(u, net.lowest_degree_nodes(u, M))
    return ov, net.compute_categories(ov)


def _consts(core):
    return core.ConvergenceConstants(epsilon=0.05)


@pytest.fixture(scope="module")
def paper():
    """The paper instance in both packages, the five JAX designs with the
    optimiser recorded, and the port's five designs replaying it."""
    jcompat.ensure_x64()
    jov, jcats = _paper(jnet)
    tov, tcats = _paper(tnet)
    rec = RecordedOptimiser()
    jout, tout = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        rec.record(mp)
        for s in SCHEMES:
            jout[s] = jcore.design(
                s, jcats, jnet.PAPER_MODEL_BYTES, M, overlay=jov,
                iterations=12, constants=_consts(jcore))
    with pytest.MonkeyPatch.context() as mp:
        rec.replay(mp)
        for s in SCHEMES:
            tout[s] = tcore.design(
                s, tcats, tnet.PAPER_MODEL_BYTES, M, overlay=tov,
                iterations=12, constants=_consts(tcore), device="cpu")
    return dict(jov=jov, jcats=jcats, tov=tov, tcats=tcats, rec=rec,
                jout=jout, tout=tout)


# ---------------------------------------------------------------------------
# core/mixing.py: host numpy, bitwise
# ---------------------------------------------------------------------------


def _random_w(seed: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    links = [(i, j) for i in range(m) for j in range(i + 1, m)
             if rng.random() < 0.5] or [(0, 1)]
    return jmix.matrix_from_weights(m, links, rng.uniform(0.05, 0.4, len(links)))


@pytest.mark.parametrize("m", [3, 7, 12])
@pytest.mark.parametrize("seed", range(4))
def test_mixing_helpers_are_bitwise(seed, m):
    w = _random_w(seed, m)
    jr, jg = jmix.rho_and_gradient(w)
    tr, tg = tmix.rho_and_gradient(w.copy())
    assert tr == jr and np.array_equal(tg, jg)
    assert np.array_equal(tmix.rho_gradient(w), jmix.rho_gradient(w))
    assert tmix.rho(w) == jmix.rho(w)
    links = tmix.weights_from_matrix(w)[0]
    assert np.array_equal(tmix.incidence_matrix(m, links),
                          jmix.incidence_matrix(m, links))
    assert np.array_equal(tmix.swapping_matrix(m, 0, m - 1),
                          jmix.swapping_matrix(m, 0, m - 1))
    rng = np.random.default_rng(seed)
    for atom in (None, (0, m - 1), tuple(sorted(rng.choice(m, 2, False)))):
        gamma = float(rng.uniform(0.01, 0.9))
        jw, tw = w.copy(), w.copy()
        jmix.fw_step(jw, gamma, atom)
        tmix.fw_step(tw, gamma, atom)
        assert np.array_equal(tw, jw), atom
    for c in (tmix.ConvergenceConstants(),
              tmix.ConvergenceConstants(epsilon=0.05, m1=0.5, m2=2.0,
                                        sigma_hat=1.3, zeta_hat=0.7)):
        jc = jmix.ConvergenceConstants(**c.__dict__)
        for r in (0.0, jr, 0.5, 0.999, 1.0, 1.5):
            jk = jmix.iterations_to_converge(r, m, jc)
            assert tmix.iterations_to_converge(r, m, c) == jk
            assert tmix.total_time(123.25, r, m, c) == jmix.total_time(
                123.25, r, m, jc)
    if m > 3:
        t_ok = int(16 * m / 3) + 1
        assert tfmmd.theorem35_bound(m, t_ok, 1.25e5, 9.447e7) == (
            jfmmd.theorem35_bound(m, t_ok, 1.25e5, 9.447e7))


@pytest.mark.parametrize("variant", ["fmmd", "fmmd-p"])
@pytest.mark.parametrize("iterations", [0, 1, 5, 12, 30])
def test_fmmd_frank_wolfe_loop_is_bitwise(paper, variant, iterations):
    """FMMD and FMMD-P without the weight optimization: host numpy only."""
    kw = dict(categories=None, kappa=1.0, priority=False)
    if variant == "fmmd-p":
        kw = dict(categories=paper["jcats"], kappa=jnet.PAPER_MODEL_BYTES,
                  priority=True)
    j = jfmmd.fmmd(M, iterations, **kw)
    if variant == "fmmd-p":
        kw["categories"] = paper["tcats"]
    t = tfmmd.fmmd(M, iterations, **kw)
    assert_same_design(j, t, f"{variant}-{iterations}")


# ---------------------------------------------------------------------------
# core/weight_opt.py: the smoothed objective and the Adam step
# ---------------------------------------------------------------------------


def _support(kind: str):
    if kind == "ring":
        return [(min(i, (i + 1) % M), max(i, (i + 1) % M)) for i in range(M)]
    rng = np.random.default_rng(7)
    return [(i, j) for i in range(M) for j in range(i + 1, M)
            if rng.random() < 0.3]


def _args(links):
    rows = [i for i, _ in links]
    cols = [j for _, j in links]
    return (jnp.array(rows), jnp.array(cols),
            torch.tensor(rows), torch.tensor(cols))


def _l1(kind: str, n: int):
    if kind == "zero":
        return 0.0
    return np.random.default_rng(3).uniform(0.05, 2.5, n)


@pytest.mark.parametrize("l1", ["zero", "array"])
@pytest.mark.parametrize("beta", [40.0, 2560.0])
@pytest.mark.parametrize("support", ["ring", "random"])
def test_smoothed_rho_value_and_gradient(support, beta, l1):
    """Against ``jax.value_and_grad`` under x64 at rtol 1e-12, at an α with
    an exact 0 (where the ℓ1 term takes JAX's subgradient, +1)."""
    jcompat.ensure_x64()
    links = _support(support)
    jr, jc, tr, tc = _args(links)
    alpha = np.random.default_rng(1).uniform(-0.1, 0.4, len(links))
    alpha[1] = 0.0
    lam = _l1(l1, len(links))
    jv, jg = jax.value_and_grad(jwo._smoothed_rho)(
        jnp.asarray(alpha), jr, jc, M, beta, lam)
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    lam_t = lam if np.isscalar(lam) else torch.tensor(lam)
    tv = two._smoothed_rho(a, tr, tc, M, beta, lam_t)
    (tg,) = torch.autograd.grad(tv, a)
    assert tv.dtype == torch.float64
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12, atol=0)
    if l1 == "array":
        # the exact zero took +l1, as in JAX (torch's abs would give 0)
        no_l1 = jax.grad(jwo._smoothed_rho)(
            jnp.asarray(alpha), jr, jc, M, beta, 0.0)
        assert float(jg[1] - no_l1[1]) == pytest.approx(lam[1], rel=1e-12)


class _RecordedSteps:
    """Stands in for ``jax`` inside ``repro.core.weight_opt``: its ``jit``
    wraps the reference's Adam ``step`` so that each call's state
    ``(α, m, v, t, β)`` and result are recorded, everything else is
    ``jax`` itself. The reference then runs its own schedule unchanged."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        jitted = jax.jit(fn, **kwargs)

        def call(*args):
            out = jitted(*args)
            self.calls.append((args, out))
            return out

        return call


def _gradient_terms(alpha, links, beta, l1) -> np.ndarray:
    """The magnitude of the terms that ``_smoothed_rho``'s gradient sums,
    per link (i, j): Σ_k (p_k + q_k)·(v_k[i] − v_k[j])² + |l1|, where v_k
    are the eigenvectors of W(α) − J and p, q the softmax weights of
    β·λ_k and −β·λ_k. Near a stationary point the gradient itself is
    nearly 0 while these stay of order 1/m."""
    a = tmix.matrix_from_weights(M, links, alpha) - np.full((M, M), 1.0 / M)
    lam, vec = np.linalg.eigh(a)
    z = beta * np.concatenate([lam, -lam])
    p = np.exp(z - z.max())
    p /= p.sum()
    rows = [i for i, _ in links]
    cols = [j for _, j in links]
    return (vec[rows] - vec[cols]) ** 2 @ (p[:M] + p[M:]) + np.abs(l1)


def _assert_within(got, want, scale, rtol: float, what: str) -> None:
    err = np.abs(got - want)
    bad = err > rtol * scale
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} entries beyond rtol {rtol} of the terms' "
        f"magnitude, worst {float((err / scale).max())}")


@pytest.mark.parametrize("l1", ["zero", "array"])
@pytest.mark.parametrize("support", ["ring", "random"])
def test_adam_step_teacher_forced(support, l1):
    """Along the reference's own ``optimize_weights`` run (its start, 200
    steps at each of β = 40, 160, 640, 2560, and at l1 = 0 the polish
    restart of 200 more from the uniform optimum at β = 2560), every state
    (α, m, v, t, β) goes through the port's ``adam_step``. Its result must
    equal the update computed from ``_smoothed_rho``'s JAX gradient with
    the reference's formula (``weight_opt.py:105-109``) to rtol 1e-10 of
    the magnitude of the terms each output sums: |0.9·m| + 0.1·(the
    gradient's own terms, ``_gradient_terms``) for m, |α| +
    |lr·m̂/(√v̂+1e-8)| for α, v itself. Where terms cancel (the gradient
    near a stationary point, m as g changes sign, α as the ℓ1 term drives
    a weight to ~1e-6) the result is far smaller than its terms, and rtol
    of the result alone would measure the two eigensolvers' last-bit
    difference amplified by the cancellation, not the port. The value must
    match the reference's at rtol 1e-12."""
    jcompat.ensure_x64()
    links = _support(support)
    jr, jc, tr, tc = _args(links)
    lam = _l1(l1, len(links))
    lam_t = lam if np.isscalar(lam) else torch.tensor(lam)
    lr = 0.05
    rec = _RecordedSteps()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwo, "jax", rec)
        jwo.optimize_weights(M, links, l1=lam)
    assert len(rec.calls) == (1000 if l1 == "zero" else 800)
    grad = jax.jit(jax.grad(jwo._smoothed_rho), static_argnums=(3, 4))
    for (alpha, mom, vel, t, beta), (_, _, _, jval) in rec.calls:
        a0, m0, v0 = (np.asarray(x) for x in (alpha, mom, vel))
        g = np.asarray(grad(alpha, jr, jc, M, beta, lam))
        want_m = 0.9 * m0 + 0.1 * g
        want_v = 0.999 * v0 + 0.001 * g * g
        step = lr * (want_m / (1.0 - 0.9 ** t)) / (
            np.sqrt(want_v / (1.0 - 0.999 ** t)) + 1e-8)
        want_a = a0 - step
        ta, tm, tv, tval = two.adam_step(
            torch.tensor(a0), torch.tensor(m0), torch.tensor(v0),
            float(t), beta, tr, tc, M, lr, lam_t)
        where = f"t={t} beta={beta}"
        terms = _gradient_terms(a0, links, beta, lam)
        _assert_within(tm.numpy(), want_m, 0.9 * np.abs(m0) + 0.1 * terms,
                       1e-10, f"m at {where}")
        _assert_within(tv.numpy(), want_v, np.abs(want_v), 1e-10,
                       f"v at {where}")
        _assert_within(ta.numpy(), want_a, np.abs(a0) + np.abs(step), 1e-10,
                       f"alpha at {where}")
        np.testing.assert_allclose(float(tval), float(jval), rtol=1e-12)


def test_optimize_weights_edge_cases():
    """Empty support, duplicate links, and the analytic optima the
    reference's own tests use (clique ⇒ W = J, ρ ≈ 0)."""
    empty = two.optimize_weights(4, [], device="cpu")
    assert empty.links == () and np.array_equal(empty.matrix, np.eye(4))
    assert empty.iterations == 0 and empty.rho == 1.0
    with pytest.raises(ValueError, match="duplicate"):
        two.optimize_weights(4, [(0, 1), (1, 0)], device="cpu")
    clique = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    res = two.optimize_weights(5, clique, device="cpu")
    assert res.rho < 1e-9 and res.iterations == 800
    np.testing.assert_allclose(res.matrix, np.full((5, 5), 0.2), atol=1e-9)
    assert res.alpha.dtype == np.float64


# ---------------------------------------------------------------------------
# Prim: the port's copy of networkx's tie order
# ---------------------------------------------------------------------------

PRIM_CASES = (
    [(f"roofnet-{s}", "roofnet_like", dict(seed=s)) for s in range(8)]
    + [("line-7", "line_underlay", dict(n=7)),
       ("grid-3x4", "grid_underlay", dict(rows=3, cols=4)),
       ("grid-4x4", "grid_underlay", dict(rows=4, cols=4))]
    + [(f"geometric-{s}", "random_geometric_underlay",
        dict(n=14, radius=0.45, seed=s)) for s in range(4)]
    + [("dumbbell-3-3", "dumbbell_underlay", dict(left=3, right=3)),
       ("dumbbell-4-2", "dumbbell_underlay", dict(left=4, right=2))]
)


@pytest.mark.parametrize("name,gen,kwargs", PRIM_CASES,
                         ids=[c[0] for c in PRIM_CASES])
def test_prim_links_equal_the_references(name, gen, kwargs):
    links = []
    for net, core in ((jnet, jcore), (tnet, tcore)):
        u = getattr(net, gen)(**kwargs)
        agents = (net.lowest_degree_nodes(u, M) if name.startswith("roofnet")
                  else list(u.graph.nodes)[: min(8, u.num_nodes)])
        links.append(core.prim_links(net.build_overlay(u, agents)))
    assert links[1] == links[0]
    assert len(links[1]) == len({a for l in links[1] for a in l}) - 1


@pytest.mark.parametrize("seed", range(6))
def test_minimum_spanning_tree_is_networkx_prim(seed):
    """Random graphs with heavy ties, missing weights, isolated nodes and
    labels out of insertion order: same nodes, same edges, same order."""
    rng = random.Random(seed)
    for _ in range(40):
        n = rng.randint(1, 12)
        labels = rng.sample(range(60), n) if rng.random() < 0.5 else list(range(n))
        g, h = nx.Graph(), Graph()
        for u in labels:
            if rng.random() < 0.3:
                g.add_node(u)
                h.add_node(u)
        for _ in range(rng.randint(0, 30)):
            if n < 2:
                break
            u, v = rng.sample(labels, 2)
            attr = {} if rng.random() < 0.1 else {
                "weight": rng.choice([1.0, 2.0, 0.5, rng.random()])}
            g.add_edge(u, v, **attr)
            h.add_edge(u, v, **attr)
        want = nx.minimum_spanning_tree(g, algorithm="prim")
        got = minimum_spanning_tree(h)
        assert list(got.nodes) == list(want.nodes)
        assert list(got.edges(data=True)) == list(want.edges(data=True))
    bad = Graph()
    bad.add_edge(0, 1, weight=float("nan"))
    with pytest.raises(ValueError, match="NaN"):
        minimum_spanning_tree(bad)


# ---------------------------------------------------------------------------
# The designer: host logic with the optimiser recorded, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_design_with_the_optimiser_recorded_is_bitwise(paper, scheme):
    assert_same_outcome(paper["jout"][scheme], paper["tout"][scheme], scheme)
    assert isinstance(paper["tout"][scheme], tcore.DesignOutcome)


def test_design_replayed_every_recorded_call_in_order(paper):
    rec = paper["rec"]
    assert rec.port_calls == rec.jax_calls
    # one call per fixed-support scheme and FMMD-WP, the rest SCA's sweep
    assert len(rec.jax_calls) > len(SCHEMES)


def test_sweep_iterations_with_the_optimiser_recorded_is_bitwise(paper):
    rec = RecordedOptimiser()
    with pytest.MonkeyPatch.context() as mp:
        rec.record(mp)
        j = jcore.sweep_iterations(paper["jcats"], jnet.PAPER_MODEL_BYTES, M)
    with pytest.MonkeyPatch.context() as mp:
        rec.replay(mp)
        t = tcore.sweep_iterations(
            paper["tcats"], tnet.PAPER_MODEL_BYTES, M, device="cpu")
    assert_same_outcome(j, t, "sweep")
    assert rec.port_calls == rec.jax_calls and len(rec.jax_calls) == 6


# ---------------------------------------------------------------------------
# The unpatched port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["clique", "ring", "prim", "fmmd-wp"])
def test_unpatched_port_reproduces_supports_and_tau(paper, scheme):
    """These supports do not depend on where Adam ends (fmmd-wp's weight
    polish keeps every selected link nonzero), so links and τ are the
    JAX package's; W is the port's own Adam result."""
    out = tcore.design(
        scheme, paper["tcats"], tnet.PAPER_MODEL_BYTES, M,
        overlay=paper["tov"], iterations=12, constants=_consts(tcore),
        device="cpu")
    j = paper["jout"][scheme]
    assert out.design.activated_links == j.design.activated_links
    assert out.tau == j.tau
    tmix.validate_mixing(out.design.matrix)
    assert out.rho < 1.0


def test_unpatched_sca_picks_a_valid_candidate(paper):
    """SCA goes through Adam, so its support is the port's own. It must be
    a valid W whose support is one of the λ sweep's candidates — the one
    with the least estimated total time."""
    finals = []
    real = two.optimize_weights

    def spy(m, links, *args, **kwargs):
        res = real(m, links, *args, **kwargs)
        if np.isscalar(kwargs.get("l1", 0.0)):
            finals.append(res)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcore.sca, "optimize_weights", spy)
        d = tcore.sca_design(M, paper["tcats"], tnet.PAPER_MODEL_BYTES,
                             _consts(tcore), device="cpu")
    tmix.validate_mixing(d.matrix)
    assert d.rho < 1.0 and d.variant == "SCA"
    cands = [tuple(tmix.weights_from_matrix(r.matrix)[0]) for r in finals]
    assert d.activated_links in cands
    totals = [
        tmix.total_time(
            tfmmd._tau_bar(frozenset(c), paper["tcats"],
                           tnet.PAPER_MODEL_BYTES),
            r.rho, M, _consts(tcore))
        for c, r in zip(cands, finals)
    ]
    assert totals[cands.index(d.activated_links)] == min(totals)


# ---------------------------------------------------------------------------
# engine="torch" on the CPU against engine="jax"
# ---------------------------------------------------------------------------


def _markov(net, ov, links, tau):
    return net.StochasticScenario(
        links=(net.MarkovLinkModel(
            edges=tuple(net.mid_path_edges(ov, links)), scales=(1.0, 0.2),
            transition=((0.8, 0.2), (0.3, 0.7)),
        ),),
        step=max(tau / 2, 1.0), horizon=4 * max(tau, 1.0),
    )


@pytest.mark.parametrize("scheme", ["ring", "prim", "fmmd-wp"])
def test_engine_torch_prices_like_engine_jax(paper, scheme):
    jd, td = paper["jout"][scheme], paper["tout"][scheme]
    links = td.design.activated_links
    jsto = _markov(jnet, paper["jov"], links, jd.tau)
    tsto = _markov(tnet, paper["tov"], links, td.tau)
    kw = dict(optimize_routing=False, stochastic_rollouts=16,
              stochastic_seed=3)
    j = jcore.evaluate_design(
        jd.design, paper["jcats"], jnet.PAPER_MODEL_BYTES, M,
        _consts(jcore), overlay=paper["jov"], stochastic=jsto,
        engine="jax", **kw)
    cache: dict = {}
    t = tcore.evaluate_design(
        td.design, paper["tcats"], tnet.PAPER_MODEL_BYTES, M,
        _consts(tcore), overlay=paper["tov"], stochastic=tsto,
        engine="torch", device="cpu", routing_cache=cache, **kw)
    assert ("torch-device-incidence", frozenset(links)) in cache
    assert len(t.tau_samples) == 16
    np.testing.assert_allclose(t.tau_samples, j.tau_samples, rtol=1e-9, atol=0)
    for f in ("tau_mean", "tau_p95", "tau_p99", "tau", "total_time"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-9,
                                   atol=0, err_msg=f)
    host = tcore.evaluate_design(
        td.design, paper["tcats"], tnet.PAPER_MODEL_BYTES, M,
        _consts(tcore), overlay=paper["tov"], stochastic=tsto,
        engine="batched", **kw)
    np.testing.assert_allclose(t.tau_samples, host.tau_samples, rtol=1e-9,
                               atol=0)


def test_engine_torch_refuses_reroute_per_phase_as_jax_does(paper):
    jd, td = paper["jout"]["ring"], paper["tout"]["ring"]
    jsto = _markov(jnet, paper["jov"], jd.design.activated_links, jd.tau)
    tsto = _markov(tnet, paper["tov"], td.design.activated_links, td.tau)
    with pytest.raises(ValueError, match="engine='jax'"):
        jcore.evaluate_design(
            jd.design, paper["jcats"], jnet.PAPER_MODEL_BYTES, M,
            overlay=paper["jov"], stochastic=jsto, reroute_per_phase=True,
            engine="jax")
    with pytest.raises(ValueError, match="engine='torch'"):
        tcore.evaluate_design(
            td.design, paper["tcats"], tnet.PAPER_MODEL_BYTES, M,
            overlay=paper["tov"], stochastic=tsto, reroute_per_phase=True,
            engine="torch", device="cpu")
    with pytest.raises(ValueError, match="unknown design method"):
        tcore.design("star", paper["tcats"], 1.0, M, device="cpu")
    with pytest.raises(ValueError, match="prim needs the overlay"):
        tcore.design("prim", paper["tcats"], 1.0, M, device="cpu")
