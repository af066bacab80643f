"""Shared helpers of the designer and gate parity tests
(tests/test_torch_designer.py, test_torch_paper_gate.py).

The reference's Adam trajectory is chaotic in the last bit: two starts
1e-15 apart, or a faithful float64 transcript in another framework, end
at different weights after a few hundred steps. So the port's host logic
is held to the JAX package with the optimiser *recorded*: every call of
the JAX package's ``optimize_weights`` made by its designer is recorded,
and the port's designer is handed back those very results, call by call,
keyed by every argument. The step itself is held teacher-forced in
test_torch_designer.py."""

import importlib

import numpy as np

from repro.core import weight_opt as jwo
from repro_torch.core import weight_opt as two

# The modules that call ``optimize_weights`` (by module: ``repro.core.fmmd``
# as an attribute is the function of that name).
_CALLERS = ("fmmd", "sca", "topology_baselines")
JAX_CALLERS = tuple(
    importlib.import_module(f"repro.core.{m}") for m in _CALLERS)
PORT_CALLERS = tuple(
    importlib.import_module(f"repro_torch.core.{m}") for m in _CALLERS)


def call_key(m, links, init_alpha=None, steps=800,
             betas=(40.0, 160.0, 640.0, 2560.0), lr=0.05, l1=0.0, seed=0):
    """Every argument of ``optimize_weights``, arrays by their bytes."""
    return (
        int(m),
        tuple((int(i), int(j)) for i, j in links),
        None if init_alpha is None
        else np.asarray(init_alpha, dtype=np.float64).tobytes(),
        int(steps),
        tuple(float(b) for b in betas),
        float(lr),
        float(l1) if np.isscalar(l1)
        else np.asarray(l1, dtype=np.float64).tobytes(),
        int(seed),
    )


def to_port(res) -> two.WeightOptResult:
    """A JAX ``WeightOptResult`` as the port's, value for value."""
    return two.WeightOptResult(
        matrix=np.array(res.matrix, dtype=np.float64),
        alpha=np.array(res.alpha, dtype=np.float64),
        links=tuple((int(i), int(j)) for i, j in res.links),
        rho=float(res.rho),
        iterations=int(res.iterations),
    )


class RecordedOptimiser:
    """Record the JAX package's ``optimize_weights`` calls, then replay
    their results to the port. ``record``/``replay`` patch the name in
    every designer module of the package through ``monkeypatch``."""

    def __init__(self):
        self.results: dict = {}
        self.jax_calls: list = []
        self.port_calls: list = []

    def record(self, monkeypatch) -> None:
        def recorded(*args, **kwargs):
            res = jwo.optimize_weights(*args, **kwargs)
            key = call_key(*args, **kwargs)
            self.jax_calls.append(key)
            self.results[key] = to_port(res)
            return res

        for mod in JAX_CALLERS:
            monkeypatch.setattr(mod, "optimize_weights", recorded)

    def replay(self, monkeypatch) -> None:
        def replayed(*args, device=None, **kwargs):
            key = call_key(*args, **kwargs)
            self.port_calls.append(key)
            return self.results[key]

        for mod in PORT_CALLERS:
            monkeypatch.setattr(mod, "optimize_weights", replayed)


def assert_same_design(j, t, where: str) -> None:
    """Two ``FMMDResult``s bitwise, except ``design_seconds`` (wall time)."""
    assert t.variant == j.variant, where
    assert t.activated_links == tuple(
        (int(a), int(b)) for a, b in j.activated_links), where
    assert t.matrix.dtype == j.matrix.dtype, where
    assert np.array_equal(t.matrix, j.matrix), where
    assert t.rho == j.rho, (where, t.rho, j.rho)
    assert t.rho_trajectory == j.rho_trajectory, where
    assert t.selected_atoms == j.selected_atoms, where


def assert_same_outcome(j, t, where: str) -> None:
    """Two ``DesignOutcome``s bitwise in the design and its pricing
    (links, W, τ, τ̄, ρ, K(ρ), total time; ``design_seconds`` and the
    routing's ``solve_seconds`` are wall time and left out)."""
    assert_same_design(j.design, t.design, where)
    assert t.tau == j.tau, (where, t.tau, j.tau)
    assert t.tau_bar == j.tau_bar, (where, t.tau_bar, j.tau_bar)
    assert t.rho == j.rho, where
    assert t.iterations_to_eps == j.iterations_to_eps, where
    assert t.total_time == j.total_time, where
    assert t.routing.method == j.routing.method, where
    assert t.routing.trees == tuple(
        frozenset((int(a), int(b)) for a, b in tr) for tr in j.routing.trees
    ), where
