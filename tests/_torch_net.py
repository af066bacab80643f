"""Shared helpers of the network parity tests (tests/test_torch_net.py,
test_torch_engine.py, test_torch_pricers.py): every instance is built twice
from the same seeds, once with the JAX package's ``repro.net`` and once
with the port's ``repro_torch.net``, and results are compared as numpy /
plain Python values."""

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import pytest

import repro.net as jnet
import repro_torch.net as tnet

NETS = (jnet, tnet)


def random_instance(net, seed: int, m: int, relay: bool = False):
    """``tests/test_jax_engine.py``'s ``_random_instance`` over ``net``."""
    u = net.random_geometric_underlay(12, radius=0.5, seed=seed)
    ov = net.build_overlay(u, list(u.graph.nodes)[:m])
    cats = net.compute_categories(ov)
    rng = np.random.default_rng(seed)
    links = [
        (i, j) for i in range(m) for j in range(i + 1, m)
        if rng.random() < 0.6
    ] or [(0, 1)]
    demands = net.demands_from_links(links, 1e6, m)
    if relay:
        sol = net.route_congestion_aware(demands, cats, 1e6, m, rounds=2)
    else:
        sol = net.route_direct(demands, cats, 1e6)
    return sol, ov


def line_instance(net, kappa=1e6, capacity=125_000.0):
    """Two agents on one link: τ = κ/C = 8 s, hand-checkable."""
    u = net.line_underlay(2, capacity=capacity)
    ov = net.build_overlay(u, [0, 1])
    cats = net.compute_categories(ov)
    demands = net.demands_from_links([(0, 1)], kappa, 2)
    return net.route_direct(demands, cats, kappa), ov


def two_state(net, edges, stay_good=0.5, stay_bad=0.75, drop=0.1):
    return net.MarkovLinkModel(
        edges=edges, scales=(1.0, drop),
        transition=(
            (stay_good, 1.0 - stay_good),
            (1.0 - stay_bad, stay_bad),
        ),
    )


def stochastic_for(net, ov, tau, churn=False):
    """``tests/test_jax_engine.py``'s ``_stochastic_for`` over ``net``."""
    edges = tuple(ov.underlay.graph.edges)[:4] or ((0, 1),)
    return net.StochasticScenario(
        links=(two_state(net, edges),),
        step=0.4 * tau, horizon=4 * tau,
        churn_agents=(0,) if churn else (),
        churn_hazard=0.15 if churn else 0.0,
    )


def both(make, *args, **kwargs):
    """``(make(repro.net, ...), make(repro_torch.net, ...))``."""
    return tuple(make(net, *args, **kwargs) for net in NETS)


def _same_float(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def assert_same(a, b, where: str = "value"):
    """``a`` (JAX package) and ``b`` (port) hold bitwise the same values:
    dataclasses of the same name field by field, mappings in the same
    iteration order, arrays with the same dtype, floats bitwise (NaN
    equal to NaN)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(
                getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}"
            )
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, Mapping):
        assert isinstance(b, Mapping), where
        assert list(a.keys()) == list(b.keys()), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{k}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and _same_float(a, b), (where, a, b)
    else:
        assert a == b, (where, a, b)


def assert_parity(got, ref, rtol=1e-9):
    """One ``SimResult`` against another: makespan and flow completions at
    ``rtol``, NaN where the reference has NaN, same cancellations."""
    if np.isnan(ref.makespan):
        assert np.isnan(got.makespan)
    else:
        assert got.makespan == pytest.approx(ref.makespan, rel=rtol)
    assert len(got.flow_completion) == len(ref.flow_completion)
    for a, b in zip(got.flow_completion, ref.flow_completion):
        if np.isnan(b):
            assert np.isnan(a)
        else:
            assert a == pytest.approx(b, rel=rtol)
    assert got.cancelled_branches == ref.cancelled_branches
    assert got.unfinished_branches == ref.unfinished_branches
