"""The port's pricers (``repro_torch.core.priced_training``: ``PhasedTau``,
``StochasticTau``, ``pricer_for``) against the JAX package's on the paper's
instance (roofnet_like, 10 lowest-degree agents, an FMMD-WP design from the
JAX designer handed over through plain values). τ and the charged
wall-clock are host float64 in both packages: on a deterministic scenario
and on a seeded stochastic one priced on the host, the charged τ sequence
and the wall-clock are bitwise the JAX package's, and the wall-clock is
bitwise the running sum. The device engines (torch here, XLA there) group
the water-fill drain differently — XLA contracts it into fused
multiply-adds on the CPU — so their samples are held at rtol 1e-9."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.net as jnet
import repro_torch.net as tnet
from repro.core import ConvergenceConstants, design
from repro.core import dpsgd as jax_dpsgd
from repro.core import priced_training as jpt
from repro_torch.core import dpsgd
from repro_torch.core import priced_training as tpt

M = 10
STEPS = 8
CONSTS = ConvergenceConstants(epsilon=0.05)


def _overlay(net):
    u = net.roofnet_like(seed=0)
    return net.build_overlay(u, net.lowest_degree_nodes(u, M))


def _port_outcome(out):
    """The JAX ``DesignOutcome`` as the duck-typed outcome the port's
    pricers read, rebuilt from plain values."""
    sol = out.routing
    routing = tnet.RoutingSolution(
        demands=tuple(
            tnet.MulticastDemand(
                int(d.source), frozenset(int(x) for x in d.destinations),
                float(d.size),
            )
            for d in sol.demands
        ),
        trees=tuple(
            frozenset((int(i), int(j)) for i, j in t) for t in sol.trees
        ),
        completion_time=float(sol.completion_time),
        method=sol.method,
        solve_seconds=float(sol.solve_seconds),
    )
    return types.SimpleNamespace(
        routing=routing,
        design=types.SimpleNamespace(
            activated_links=tuple(
                (int(i), int(j)) for i, j in out.design.activated_links),
            matrix=np.asarray(out.design.matrix, dtype=np.float64),
        ),
        tau=float(out.tau),
        tau_samples=tuple(float(x) for x in out.tau_samples),
        name=out.name,
    )


def _markov(net, ov, links, tau):
    hops = net.mid_path_edges(ov, links)
    return net.StochasticScenario(
        links=(net.MarkovLinkModel(
            edges=tuple(hops), scales=(1.0, 0.2),
            transition=((0.8, 0.2), (0.3, 0.7)),
        ),),
        step=max(tau / 2, 1.0), horizon=4 * max(tau, 1.0),
    )


@pytest.fixture(scope="module")
def paper():
    jov = _overlay(jnet)
    cats = jnet.compute_categories(jov)
    out = design(
        "fmmd-wp", cats, jnet.PAPER_MODEL_BYTES, M, overlay=jov,
        iterations=12, constants=CONSTS, optimize_routing=False,
    )
    sto = _markov(jnet, jov, out.design.activated_links, out.tau)
    priced = design(
        "fmmd-wp", cats, jnet.PAPER_MODEL_BYTES, M, overlay=jov,
        iterations=12, constants=CONSTS, optimize_routing=False,
        stochastic=sto, stochastic_rollouts=8,
    )
    tov = _overlay(tnet)
    assert list(tov.paths.items()) == list(jov.paths.items())
    return types.SimpleNamespace(
        jov=jov, tov=tov, out=out, priced=priced,
        tout=_port_outcome(out), tpriced=_port_outcome(priced),
    )


def _train_both(jpricer, tpricer, w, rounds=1):
    """``train_priced`` in both packages on a heterogeneous quadratic
    (agent i pulls toward i), ``STEPS`` steps, same W and pricer kind."""
    targets = np.arange(M, dtype=np.float32)[:, None]
    jstep = jax_dpsgd.make_dpsgd_step(
        lambda p, b: jnp.mean((p["x"] - b) ** 2), learning_rate=0.05)
    _, jlog = jpt.train_priced(
        {"x": jnp.zeros((M, 1))}, jstep, lambda k: jnp.asarray(targets),
        jnp.asarray(w, jnp.float32), jpricer, STEPS,
        strategy=jpt.GossipStrategy(rounds=rounds),
    )
    tstep = dpsgd.make_dpsgd_step(
        lambda p, b: torch.mean((p["x"] - b) ** 2), learning_rate=0.05)
    _, tlog = tpt.train_priced(
        {"x": torch.zeros((M, 1))}, tstep,
        lambda k: torch.from_numpy(targets), w, tpricer, STEPS,
        strategy=tpt.GossipStrategy(rounds=rounds), device="cpu",
    )
    return jlog, tlog


def _assert_same_charges(jlog, tlog):
    tlog.validate()
    assert len(tlog.records) == len(jlog.records) == STEPS
    wall = 0.0
    for jr, tr in zip(jlog.records, tlog.records):
        assert tr.tau == jr.tau and tr.wall_clock == jr.wall_clock  # bitwise
        assert tr.pricing == jr.pricing and tr.gossip_rounds == jr.gossip_rounds
        wall += tr.tau
        assert tr.wall_clock == wall
        np.testing.assert_allclose(tr.loss, jr.loss, rtol=1e-5)
    assert tlog.total_wall == jlog.total_wall


def _scenarios(net, ov, links, tau):
    hops = net.mid_path_edges(ov, links)
    return {
        "global-sag": net.Scenario(
            capacity_phases=(net.CapacityPhase(start=2.5 * tau, scale=0.5),)),
        "edge-sag": net.Scenario(capacity_phases=(
            net.CapacityPhase(start=1.5 * tau,
                              scale={e: 0.3 for e in hops[::2]}),
            net.CapacityPhase(start=4.5 * tau, scale=1.0),
        )),
        "steps": net.Scenario(capacity_phases=tuple(
            net.CapacityPhase(start=k * 0.7 * tau, scale=1.0 - 0.1 * k)
            for k in range(1, 6))),
    }


@pytest.mark.parametrize("name", ["global-sag", "edge-sag", "steps"])
@pytest.mark.parametrize("rounds", [1, 2], ids=["one-shot", "gossip-x2"])
def test_phased_tau_is_bitwise_the_references(paper, name, rounds):
    links = paper.out.design.activated_links
    jsc = _scenarios(jnet, paper.jov, links, paper.out.tau)[name]
    tsc = _scenarios(tnet, paper.tov, links, paper.tout.tau)[name]
    jp = jpt.pricer_for(paper.out, mode="phased", overlay=paper.jov,
                        scenario=jsc)
    tp = tpt.pricer_for(paper.tout, mode="phased", overlay=paper.tov,
                        scenario=tsc)
    assert isinstance(tp, tpt.PhasedTau) and tp.engine == "batched"
    jlog, tlog = _train_both(jp, tp, paper.tout.design.matrix, rounds)
    _assert_same_charges(jlog, tlog)
    # the phases engaged: not every round costs the same
    assert len({r.tau for r in tlog.records}) > 1


@pytest.mark.parametrize("reduce", ["mean", "p95", "sample"])
def test_stochastic_tau_priced_on_the_host_is_bitwise(paper, reduce):
    links = paper.out.design.activated_links
    jsto = _markov(jnet, paper.jov, links, paper.out.tau)
    tsto = _markov(tnet, paper.tov, links, paper.tout.tau)
    jp = jpt.StochasticTau.price(paper.out, paper.jov, jsto, rollouts=8,
                                 seed=3, engine="batched", reduce=reduce)
    tp = tpt.StochasticTau.price(paper.tout, paper.tov, tsto, rollouts=8,
                                 seed=3, engine="batched", reduce=reduce)
    assert tp.samples == jp.samples
    assert tp.tau_mean == jp.tau_mean and tp.tau_p95 == jp.tau_p95
    jlog, tlog = _train_both(jp, tp, paper.tout.design.matrix)
    _assert_same_charges(jlog, tlog)


@pytest.mark.parametrize("reduce", ["mean", "p95", "sample"])
def test_stochastic_tau_on_the_torch_engine(paper, reduce):
    """One device pass (here on the CPU) against the JAX engine's launch
    and the port's own host loop: rtol 1e-9; the incidence is cached
    under the port's key; the charged wall-clock is the running sum."""
    links = paper.out.design.activated_links
    jsto = _markov(jnet, paper.jov, links, paper.out.tau)
    tsto = _markov(tnet, paper.tov, links, paper.tout.tau)
    cache: dict = {}
    tp = tpt.StochasticTau.price(
        paper.tout, paper.tov, tsto, rollouts=16, seed=5, engine="torch",
        reduce=reduce, routing_cache=cache, device="cpu")
    assert ("torch-device-incidence", frozenset(links)) in cache
    jp = jpt.StochasticTau.price(paper.out, paper.jov, jsto, rollouts=16,
                                 seed=5, engine="jax", reduce=reduce)
    host = tpt.StochasticTau.price(paper.tout, paper.tov, tsto, rollouts=16,
                                   seed=5, engine="batched", reduce=reduce)
    np.testing.assert_allclose(tp.samples, jp.samples, rtol=1e-9, atol=0)
    np.testing.assert_allclose(tp.samples, host.samples, rtol=1e-9, atol=0)
    again = tpt.StochasticTau.price(
        paper.tout, paper.tov, tsto, rollouts=16, seed=5, engine="torch",
        reduce=reduce, routing_cache=cache, device="cpu")
    assert again.samples == tp.samples  # replayable, bitwise
    jlog, tlog = _train_both(jp, tp, paper.tout.design.matrix)
    tlog.validate()
    for jr, tr in zip(jlog.records, tlog.records):
        np.testing.assert_allclose(tr.tau, jr.tau, rtol=1e-9, atol=0)
    if reduce == "sample":
        assert [r.tau for r in tlog.records] == [
            tp.samples[k % 16] for k in range(STEPS)]


def test_pricer_for_every_mode_is_bitwise(paper):
    # static: the outcome's τ
    js = jpt.pricer_for(paper.out)
    ts = tpt.pricer_for(paper.tout)
    assert (ts.kind, ts.tau, ts.label) == (js.kind, js.tau, js.label)
    # stochastic from the donated samples
    jd = jpt.pricer_for(paper.priced, mode="stochastic", reduce="p95")
    td = tpt.pricer_for(paper.tpriced, mode="stochastic", reduce="p95")
    assert td.samples == jd.samples and td.tau_p95 == jd.tau_p95
    # stochastic with a fresh batch on the host
    links = paper.out.design.activated_links
    jf = jpt.pricer_for(
        paper.out, mode="stochastic", overlay=paper.jov,
        stochastic=_markov(jnet, paper.jov, links, paper.out.tau),
        rollouts=4, seed=1, reduce="sample")
    tf = tpt.pricer_for(
        paper.tout, mode="stochastic", overlay=paper.tov,
        stochastic=_markov(tnet, paper.tov, links, paper.tout.tau),
        rollouts=4, seed=1, reduce="sample")
    assert tf.samples == jf.samples
    for jpr, tpr in ((js, ts), (jd, td), (jf, tf)):
        jlog, tlog = _train_both(jpr, tpr, paper.tout.design.matrix)
        _assert_same_charges(jlog, tlog)


def test_pricer_validation_errors():
    with pytest.raises(ValueError):
        tpt.StochasticTau(samples=())
    with pytest.raises(ValueError):
        tpt.StochasticTau(samples=(1.0,), reduce="median")
    with pytest.raises(ValueError):
        tpt.pricer_for(object(), mode="phased")
    with pytest.raises(ValueError):
        tpt.pricer_for(object(), mode="oracle")
    with pytest.raises(ValueError):
        tpt.PhasedTau(None, None, None)
    empty = types.SimpleNamespace(tau_samples=())
    with pytest.raises(ValueError, match="tau_samples"):
        tpt.StochasticTau.from_outcome(empty)
