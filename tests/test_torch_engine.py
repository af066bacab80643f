"""The port's float64 torch rollout engine (``repro_torch.net.torch_engine``)
on the CPU (``device="cpu"``): makespans and flow completions at rtol 1e-9
against the JAX package's engine and against the numpy oracle on the same
instances and realizations (relay, capacity phases, churn), an R-lane batch
bitwise equal to R one-lane runs, both count widths, the starvation error,
the rejected scenario surface, the padded layout's contract, float64
throughout, and no quiet CPU path without a card."""

import ast
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest
import torch

import repro.net as jnet
import repro_torch.net as tnet
from _torch_net import (
    assert_parity,
    assert_same,
    both,
    line_instance,
    random_instance,
    stochastic_for,
)
from repro.net import jax_engine as je
from repro_torch import compat
from repro_torch.analysis.contracts import ContractViolation
from repro_torch.net import torch_engine as te
from repro_torch.net.routing import PhasedRoutingSolution, RoutingSolution

CPU = "cpu"
RTOL = 1e-9


@pytest.mark.parametrize(
    "seed,m,relay",
    [(s, 3 + s % 5, s % 2 == 1) for s in range(10)],
)
def test_static_matches_jax_and_batched(seed, m, relay):
    (js, jo), (ts, to) = both(random_instance, seed, m, relay)
    got = tnet.simulate(ts, to, engine="torch", device=CPU)
    assert_parity(got, jnet.simulate(js, jo, engine="jax"), RTOL)
    assert_parity(got, tnet.simulate(ts, to, engine="batched"), RTOL)


def _phases_and_churn(net, sol, m, seed):
    tau = max(float(sol.completion_time), 1.0)
    rng = np.random.default_rng(seed + 7)
    return net.Scenario(
        capacity_phases=(
            net.CapacityPhase(start=0.3 * tau, scale=0.5),
            net.CapacityPhase(start=0.9 * tau, scale=1.5),
        ),
        churn=(
            (net.ChurnEvent(agent=int(rng.integers(m)), time=0.5 * tau),)
            if rng.random() < 0.6 else ()
        ),
    )


@pytest.mark.parametrize("seed", range(8))
def test_scenarios_match_jax_and_batched(seed):
    """Capacity phases and churn (all-branch cancellation NaNs
    included)."""
    m = 3 + seed % 4
    (js, jo), (ts, to) = both(random_instance, seed, m, seed % 3 == 0)
    jsc = _phases_and_churn(jnet, js, m, seed)
    tsc = _phases_and_churn(tnet, ts, m, seed)
    got = tnet.simulate(ts, to, scenario=tsc, engine="torch", device=CPU)
    assert_parity(got, jnet.simulate(js, jo, scenario=jsc, engine="jax"),
                  RTOL)
    assert_parity(
        got, tnet.simulate(ts, to, scenario=tsc, engine="batched"), RTOL)


@pytest.mark.parametrize("seed", range(4))
def test_phased_single_tree_matches_jax(seed):
    def phased(net, sol):
        tau = max(float(sol.completion_time), 1.0)
        routing = net.routing.PhasedRoutingSolution(
            demands=sol.demands, boundaries=(0.0, 0.5 * tau),
            solutions=(sol, sol), completion_time=tau,
            method="static", solve_seconds=0.0,
        )
        sc = net.Scenario(
            capacity_phases=(net.CapacityPhase(start=0.4 * tau, scale=0.5),)
        )
        return routing, sc

    (js, jo), (ts, to) = both(random_instance, seed, 3 + seed)
    jp, jsc = phased(jnet, js)
    tp, tsc = phased(tnet, ts)
    got = tnet.simulate_phased(tp, to, scenario=tsc, engine="torch",
                               device=CPU)
    assert_parity(
        got, jnet.simulate_phased(jp, jo, scenario=jsc, engine="jax"), RTOL)
    assert_parity(
        got, tnet.simulate_phased(tp, to, scenario=tsc, engine="batched"),
        RTOL)


def test_phased_rejects_rerouting_segments():
    u = tnet.line_underlay(3)
    ov = tnet.build_overlay(u, [0, 1, 2])
    demands = tuple(tnet.demands_from_links([(0, 1)], 1e6, 3))[:1]
    direct = RoutingSolution(
        demands=demands, trees=(frozenset({(0, 1)}),),
        completion_time=8.0, method="direct", solve_seconds=0.0,
    )
    relay = RoutingSolution(
        demands=demands, trees=(frozenset({(0, 2), (2, 1)}),),
        completion_time=16.0, method="direct", solve_seconds=0.0,
    )
    phased = PhasedRoutingSolution(
        demands=demands, boundaries=(0.0, 2.0),
        solutions=(direct, relay), completion_time=8.0,
        method="time_expanded", solve_seconds=0.0,
    )
    with pytest.raises(ValueError, match="re-rout"):
        tnet.simulate_phased(phased, ov, engine="torch", device=CPU)


@pytest.mark.parametrize(
    "seed,m,churn", [(s, 3 + s % 4, s % 2 == 0) for s in range(8)]
)
def test_rollout_batch_matches_jax_and_reference(seed, m, churn):
    """One pass over a RealizationBatch matches the JAX engine's launch
    and the numpy loop of engine="batched", per rollout, at rtol 1e-9;
    the realizations themselves are bitwise the JAX package's."""
    (js, jo), (ts, to) = both(random_instance, seed, m)
    tau = max(float(js.completion_time), 1.0)
    jinc, tinc = jnet.compile_incidence(js, jo), tnet.compile_incidence(ts, to)
    jb = stochastic_for(jnet, jo, tau, churn=churn).realization_batch(
        seed, 6, jinc)
    tb = stochastic_for(tnet, to, tau, churn=churn).realization_batch(
        seed, 6, tinc)
    assert_same(jb, tb, "RealizationBatch")
    fast = te.simulate_rollout_batch(ts, to, tb, incidence=tinc, device=CPU)
    ref = te._rollout_batch_reference(ts, to, tb, incidence=tinc)
    jax = je.simulate_rollout_batch(js, jo, jb, incidence=jinc)
    assert len(fast) == len(ref) == len(jax) == 6
    for f, r, j in zip(fast, ref, jax):
        assert_parity(f, r, RTOL)
        assert_parity(f, j, RTOL)
        assert f.num_events == j.num_events  # same event loop as JAX


def _dev_and_batch(seed=3, m=5, rollouts=8, churn=True):
    sol, ov = random_instance(tnet, seed, m)
    sto = stochastic_for(tnet, ov, max(float(sol.completion_time), 1.0),
                         churn=churn)
    inc = tnet.compile_incidence(sol, ov)
    flow_size = np.array([d.size for d in sol.demands], dtype=np.float64)
    return sol, te.device_incidence(inc, flow_size), sto.realization_batch(
        11, rollouts, inc)


@pytest.mark.parametrize("seed", [3, 6])
def test_batch_bitwise_matches_one_lane_runs(seed):
    """Batching must not change a bit: rollout r inside an R=8 pass gives
    bitwise the result of running r alone on the same boundary grid."""
    sol, dev, batch = _dev_and_batch(seed)
    together = te.rollout_batch_results(sol, dev, batch, device=CPU)
    for r in range(batch.num_rollouts):
        sub = dataclasses.replace(
            batch,
            capacity=batch.capacity[r:r + 1],
            churn=(batch.churn[r],),
            realizations=(batch.realizations[r],),
        )
        alone = te.rollout_batch_results(sol, dev, sub, device=CPU)[0]
        assert_same(together[r], alone, f"rollout {r}")


def test_int16_and_int32_counts_agree_bitwise():
    """Counts are exact integers, so the int32 path (tables of width
    2**15 and more) prices bitwise like the int16 path."""
    assert te._count_dtype(2**15 - 1) is torch.int16
    assert te._count_dtype(2**15) is torch.int32
    sol, dev, batch = _dev_and_batch(4)
    args = te.device_args(
        dev, batch.starts, batch.capacity,
        te.batch_cancel_times(dev.source, np.array(
            [d.source for d in sol.demands]), batch),
    )
    outs = {}
    for cdtype in (torch.int16, torch.int32):
        branch_cols = te._table_columns(args[0], CPU)
        edge_cols = te._table_columns(args[1], CPU)
        done, cancelled, active, events, starved = te._simulate_batch(
            torch.from_numpy(args[5]), torch.from_numpy(args[6]),
            torch.from_numpy(args[3]), torch.from_numpy(args[2]), args[4],
            int(args[7]), branch_cols, edge_cols, cdtype,
        )
        outs[cdtype] = (done.numpy(), events.numpy())
    assert np.array_equal(outs[torch.int16][0], outs[torch.int32][0],
                          equal_nan=True)
    assert np.array_equal(outs[torch.int16][1], outs[torch.int32][1])


def test_starvation_raises_like_the_reference():
    """All-zero capacity with no later boundary: no positive rate, nothing
    can finish — the numpy engines' RuntimeError, raised on the host."""
    (js, jo), (ts, to) = both(line_instance)
    jinc, tinc = jnet.compile_incidence(js, jo), tnet.compile_incidence(ts, to)
    fs = np.array([d.size for d in ts.demands])
    jdev, tdev = je.device_incidence(jinc, fs), te.device_incidence(tinc, fs)
    caps = np.zeros((2, 1, tinc.num_edges))
    cancel = np.full((2, tinc.num_branches), np.inf)
    with pytest.raises(RuntimeError, match="starved"):
        je.run_rollouts(jdev, np.zeros(1), caps, cancel)
    with pytest.raises(RuntimeError, match="starved"):
        te.run_rollouts(tdev, np.zeros(1), caps, cancel, device=CPU)


def test_rejects_unsupported_surface():
    sol, ov = line_instance(tnet)
    with pytest.raises(ValueError, match="batched"):
        tnet.simulate(
            sol, ov, engine="torch", device=CPU,
            scenario=tnet.Scenario(
                cross_traffic=(tnet.CrossTraffic(src=0, dst=1, rate=1.0),)
            ),
        )
    with pytest.raises(ValueError, match="batched"):
        tnet.simulate(
            sol, ov, engine="torch", device=CPU,
            scenario=tnet.Scenario(
                stragglers=(tnet.StragglerEvent(agent=0, slowdown=2.0),)
            ),
        )
    with pytest.raises(ValueError, match="maxmin"):
        tnet.simulate(sol, ov, engine="torch", fairness="equal", device=CPU)
    with pytest.raises(ValueError, match="maxmin"):
        te.simulate_rollout_batch(sol, ov, None, fairness="equal",
                                  device=CPU)
    with pytest.raises(ValueError, match="agent"):
        tnet.simulate(
            sol, ov, engine="torch", device=CPU,
            scenario=tnet.Scenario(churn=(tnet.ChurnEvent(agent=9, time=1.0),)),
        )
    with pytest.raises(ValueError, match="unknown engine"):
        tnet.simulate(sol, ov, engine="jax")


def test_device_incidence_is_the_references_and_holds_its_contract(
    monkeypatch,
):
    monkeypatch.setenv("REPRO_VALIDATE", "1")
    (js, jo), (ts, to) = both(random_instance, 1, 5)
    fs = np.array([d.size for d in js.demands], dtype=np.float64)
    jdev = je.device_incidence(jnet.compile_incidence(js, jo), fs)
    tdev = te.device_incidence(tnet.compile_incidence(ts, to), fs)
    assert_same(jdev, tdev, "DeviceIncidence")

    def corrupted(**kw):
        with pytest.raises(ContractViolation) as ei:
            dataclasses.replace(tdev, **kw)
        return ei.value.invariant

    bad = tdev.flat_branch.copy()
    bad[-1] = 0
    assert corrupted(flat_branch=bad) == "inert-padding"
    bad = tdev.base_capacity.copy()
    bad[-1] = 2.0
    assert corrupted(base_capacity=bad) == "inert-padding"
    bad = tdev.edge_table.copy()
    bad[0, 0] = (bad[0, 0] + 1) % tdev.num_branches
    assert corrupted(edge_table=bad) == "table-packing"
    assert corrupted(sizes=tdev.sizes.astype(np.float32)) == "dtype"
    assert corrupted(sizes=tdev.sizes[: tdev.num_branches]) == "padded-bucket"
    monkeypatch.delenv("REPRO_VALIDATE")
    bad = tdev.flat_branch.copy()
    bad[-1] = 0
    dataclasses.replace(tdev, flat_branch=bad)  # off: no validation


def test_every_tensor_is_float64(monkeypatch):
    """The water-fill sees float64 capacities and returns float64 rates;
    the batch returns float64 times; and every tensor the module creates
    names its dtype (torch's default float32 would break rtol 1e-9)."""
    seen = []
    real = te._waterfill

    def spy(active, caps, *rest):
        rates = real(active, caps, *rest)
        seen.append((active.dtype, caps.dtype, rates.dtype))
        return rates

    monkeypatch.setattr(te, "_waterfill", spy)
    sol, dev, batch = _dev_and_batch(2)
    out = te.rollout_batch_results(sol, dev, batch, device=CPU)
    assert seen and all(
        s == (torch.bool, torch.float64, torch.float64) for s in seen)
    assert all(isinstance(r.makespan, float) for r in out)

    tree = ast.parse(pathlib.Path(inspect.getfile(te)).read_text())
    makers = {"zeros", "ones", "full", "empty", "tensor", "arange",
              "as_tensor"}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "torch"
                and node.func.attr in makers):
            assert any(k.arg == "dtype" for k in node.keywords), node.lineno


def test_syncs_are_counted():
    sol, dev, batch = _dev_and_batch(5)
    te.reset_sync_count()
    res = te.rollout_batch_results(sol, dev, batch, device=CPU)
    syncs, rounds = te.sync_count(), te.round_count()
    # at least one loop test per event and two per water-fill, one copy
    events = max(r.num_events for r in res)
    assert syncs >= 2 * events + 1 and rounds >= 2 * events
    te.reset_sync_count()
    assert te.sync_count() == 0 and te.round_count() == 0


@pytest.mark.parametrize(
    "entry", ["simulate", "simulate_phased", "simulate_torch",
              "run_rollouts", "rollout_batch_results",
              "simulate_rollout_batch"],
)
def test_device_none_raises_without_a_gpu(entry):
    if torch.cuda.is_available():
        assert compat.resolve_device(None).type == "cuda"
        return
    sol, ov = line_instance(tnet)
    sol_b, dev, batch = _dev_and_batch(1, rollouts=2)
    with pytest.raises(compat.NoCudaDeviceError):
        if entry == "simulate":
            tnet.simulate(sol, ov, engine="torch")
        elif entry == "simulate_phased":
            phased = PhasedRoutingSolution(
                demands=sol.demands, boundaries=(0.0,), solutions=(sol,),
                completion_time=8.0, method="static", solve_seconds=0.0,
            )
            tnet.simulate_phased(phased, ov, engine="torch")
        elif entry == "simulate_torch":
            te.simulate_torch(sol, ov)
        elif entry == "run_rollouts":
            te.run_rollouts(dev, batch.starts, batch.capacity,
                            np.full((2, dev.num_branches), np.inf))
        elif entry == "rollout_batch_results":
            te.rollout_batch_results(sol_b, dev, batch)
        else:
            te.simulate_rollout_batch(sol_b, ov, batch)
