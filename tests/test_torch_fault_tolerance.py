"""Port `runtime/{fault_tolerance,stragglers,faultinject}.py` against the
JAX package on the same inputs: heartbeats, fault schedules, renormalized
W, straggler rounds and scenarios, failure scenarios, the single-survivor
redesign and `shrink_state`/`grow_state` are bitwise; the controller's
FMMD-WP redesigns (and their transition pricing) are bitwise with the JAX
optimiser recorded and replayed (`_torch_design.RecordedOptimiser`), and
valid on their own with the port's optimiser on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.net as jnet
import repro_torch.net as tnet
from _torch_design import RecordedOptimiser
from _torch_net import assert_same
from repro import compat as jcompat
from repro.core import mixing as jmixing
from repro.runtime import fault_tolerance as jft
from repro.runtime import faultinject as jfi
from repro.runtime import stragglers as jst
from repro_torch.core import mixing
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import faultinject as tfi
from repro_torch.runtime import stragglers as tst


@pytest.fixture(autouse=True, scope="module")
def _x64():
    """float64 on in JAX for this file's tests (as in every port test),
    and back as it was after them."""
    was = jcompat.x64_enabled()
    jcompat.ensure_x64()
    yield
    jax.config.update("jax_enable_x64", was)



def _overlay(net, m=10):
    u = net.roofnet_like(seed=0)
    return net.build_overlay(u, net.lowest_degree_nodes(u, m))


@pytest.fixture(scope="module")
def overlays():
    return _overlay(jnet), _overlay(tnet)


def test_heartbeat_detects_failure_as_the_reference():
    out = []
    for ft in (jft, tft):
        t = [0.0]
        mon = ft.HeartbeatMonitor((0, 1, 2), timeout=1.0, now=lambda: t[0])
        t[0] = 0.5
        mon.beat(0)
        mon.beat(1)
        t[0] = 1.2
        first = mon.failed()
        mon.remove(2)
        out.append((first, mon.failed()))
    assert out[0] == out[1] == ((2,), ())


class _Clock:
    def __init__(self):
        self.t = 0.0

    def advance(self, seconds):
        self.t += seconds


def _calls(fi, inj, n):
    got = []
    for k in range(n):
        try:
            got.append(("ok", inj.call(lambda k=k: k * 1.5,
                                       poison=lambda r: -r)))
        except fi.PricingTimeout as exc:
            got.append(("timeout", str(exc)))
        except fi.PricingFault as exc:
            got.append(("raise", str(exc)))
    return got


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_fault_schedule_is_bitwise_the_reference(seed, rate):
    """``default_rng((seed, call))`` draws: the same modes at the same
    calls, the same virtual time burnt by timeouts, the same results."""
    out = []
    for fi in (jfi, tfi):
        clock = _Clock()
        inj = fi.FaultInjector(fi.FaultPlan(seed=seed, rate=rate), clock=clock)
        got = _calls(fi, inj, 20)
        out.append((got, list(inj.injected), clock.t, inj.calls))
    assert out[0] == out[1]
    if rate == 1.0:
        assert len(out[1][1]) == 20


def test_faultplan_validation_as_the_reference():
    for fi in (jfi, tfi):
        with pytest.raises(ValueError, match="rate"):
            fi.FaultPlan(rate=1.5)
        with pytest.raises(ValueError, match="modes"):
            fi.FaultPlan(modes=("explode",))
        with pytest.raises(ValueError, match="timeout"):
            fi.FaultPlan(timeout_seconds=-1.0)
        inj = fi.FaultInjector(fi.FaultPlan(rate=0.0))
        assert inj.call(lambda: 42) == 42
        assert inj.injected == []


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("m", [3, 5, 8])
def test_renormalized_mixing_is_bitwise_the_reference(seed, m):
    rng = np.random.default_rng(seed)
    links = [(i, j) for i in range(m) for j in range(i + 1, m)]
    alpha = rng.uniform(0.01, 0.3, len(links))
    w = mixing.matrix_from_weights(m, links, alpha)
    drop = rng.random((m, m)) < 0.3
    delivered = ~(drop | drop.T)
    np.fill_diagonal(delivered, True)
    got = tst.renormalized_mixing(w, delivered)
    assert_same(jst.renormalized_mixing(w, delivered), got)
    mixing.validate_mixing(got)
    assert np.all(got[~delivered & ~np.eye(m, dtype=bool)] == 0.0)
    with pytest.raises(ValueError, match="symmetric"):
        tst.renormalized_mixing(w, np.triu(np.ones((m, m), bool)))


@pytest.mark.parametrize("seed", range(3))
def test_straggler_rounds_are_bitwise_the_reference(seed):
    w = mixing.matrix_from_weights(6, [(0, 1), (2, 3), (4, 5), (1, 2)],
                                   [0.3, 0.3, 0.3, 0.2])
    sims = [st.StragglerSimulator(num_agents=6, prob=0.5, severity=4.0,
                                  seed=seed) for st in (jst, tst)]
    for deadline in (None, 1.5, 5.0, None):
        a, b = (s.round_time(1.0, w, deadline=deadline) for s in sims)
        assert_same(a, b)
    a, b = (s.scenario_events(horizon=7.5, round_time=1.0) for s in sims)
    assert_same(a, b)
    for st in (jst, tst):
        assert st.deadline_from_history([]) == float("inf")
    hist = [1.0, 1.1, 0.9, 4.0]
    for q, slack, floor in ((0.75, 1.5, 0.0), (0.5, 2.0, 3.0)):
        assert tst.deadline_from_history(hist, q, slack, floor) == \
            jst.deadline_from_history(hist, q, slack, floor)


def test_deadline_and_straggler_sim():
    sim = tst.StragglerSimulator(num_agents=6, prob=0.5, severity=4.0, seed=1)
    w = mixing.matrix_from_weights(6, [(0, 1), (2, 3), (4, 5)],
                                   [0.3, 0.3, 0.3])
    t_free, delivered_free = sim.round_time(1.0, w, deadline=None)
    assert t_free >= 1.0 and delivered_free.all()
    t_dl, _ = sim.round_time(1.0, w, deadline=1.5)
    assert t_dl <= 1.5
    with pytest.raises(ValueError, match="round_time"):
        sim.scenario_events(1.0, 0.0)
    with pytest.raises(ValueError, match="horizon"):
        sim.scenario_events(float("inf"), 1.0)


@pytest.mark.parametrize("failures,slow,window", [
    ({}, 1.0, 0.0), ({3: 2.0, 1: 0.5}, 1.0, 0.0),
    ({3: 2.0, 1: 0.5}, 3.0, 1.0), ({0: 0.2}, 2.0, 5.0),
])
def test_failure_scenario_is_bitwise_the_reference(failures, slow, window):
    assert_same(jft.failure_scenario(failures, slow, window),
                tft.failure_scenario(failures, slow, window))
    assert_same(jft.churn_events_from_failures(failures),
                tft.churn_events_from_failures(failures))


def _state_pair():
    arrays = {
        "params": np.arange(8.0, dtype=np.float32).reshape(4, 2),
        "rng": np.array([7, 11], dtype=np.uint32),
        "sched": np.arange(100.0, dtype=np.float32),
        "nested": [np.arange(12.0, dtype=np.float32).reshape(4, 3)],
    }
    j = {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
             else jnp.asarray(v)) for k, v in arrays.items()}
    j["scalar"] = jnp.float32(3.0)
    t = {k: ([torch.from_numpy(x.copy()) for x in v] if isinstance(v, list)
             else torch.from_numpy(v.copy())) for k, v in arrays.items()}
    t["scalar"] = torch.tensor(3.0)
    return j, t


def _assert_state_bitwise(j, t):
    flat_j = {"params": j["params"], "rng": j["rng"], "sched": j["sched"],
              "nested": j["nested"][0], "scalar": j["scalar"]}
    flat_t = {"params": t["params"], "rng": t["rng"], "sched": t["sched"],
              "nested": t["nested"][0], "scalar": t["scalar"]}
    for k in flat_j:
        a = np.asarray(flat_j[k])
        b = flat_t[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("alive", [(0, 1), (3,), (0, 2, 3), (1, 2, 3, 0)])
def test_shrink_state_is_bitwise_the_reference(alive):
    """Only leaves whose leading dim equals the current agent count are
    sliced (the replicated key, the global schedule and the scalar stay)."""
    j, t = _state_pair()
    out = tft.shrink_state(t, alive, num_agents=4)
    _assert_state_bitwise(jft.shrink_state(j, alive, num_agents=4), out)
    assert torch.equal(out["rng"], t["rng"])
    assert out["sched"].shape == (100,)
    with pytest.raises(ValueError, match="out of range"):
        tft.shrink_state(t, (0, 5), num_agents=4)


@pytest.mark.parametrize("new_m,clone_from", [(6, 0), (7, 2), (3, 0),
                                              (4, 1)])
def test_grow_state_is_bitwise_the_reference(new_m, clone_from):
    """Every leaf with ndim >= 1 grows or is cut, whatever its leading
    dimension means — the reference's behaviour, kept."""
    j, t = _state_pair()
    out = tft.grow_state(t, new_m, clone_from=clone_from)
    _assert_state_bitwise(jft.grow_state(j, new_m, clone_from=clone_from),
                          out)
    if new_m > 4:
        assert torch.equal(out["params"][4], t["params"][clone_from])


def test_shrink_and_grow_stay_on_the_tensors_device_and_dtype():
    st = {"x": torch.arange(6.0, dtype=torch.bfloat16).reshape(3, 2)}
    g = tft.grow_state(st, 5)
    assert g["x"].dtype == torch.bfloat16 and g["x"].shape == (5, 2)
    torch.testing.assert_close(g["x"][3], g["x"][0], rtol=0, atol=0)
    s = tft.shrink_state(g, (4, 0), num_agents=5)
    assert s["x"].device == st["x"].device
    torch.testing.assert_close(s["x"], st["x"][[0, 0]], rtol=0, atol=0)


def test_redesign_single_survivor_as_the_reference(overlays):
    jov, tov = overlays
    jw, jsched, jcats = jft.redesign_after_failure(jov, (4,), 1e6)
    tw, tsched, tcats = tft.redesign_after_failure(tov, (4,), 1e6,
                                                   device="cpu")
    assert_same(jw, tw)
    assert_same(jcats, tcats)
    assert_same(jsched, tsched)


def _controller_run(ft, ov, failures, **kw):
    state = {"x": np.arange(10.0, dtype=np.float32)[:, None]}
    state = {"x": jnp.asarray(state["x"])} if ft is jft else {
        "x": torch.from_numpy(state["x"])}
    t = [100.0]

    def clock():
        t[0] += 1.0
        return t[0]

    if ft is tft:
        kw["device"] = "cpu"
    ctl = ft.FaultToleranceController(ov, kappa=1e6, clock=clock, **kw)
    out = []
    for step, (failed, times) in enumerate(failures):
        state, w, sched = ctl.handle_failures(
            failed, state, step=step, failure_times=times)
        out.append((np.asarray(state["x"]).copy(), w, sched))
    return ctl, out


FAILURES = [
    [((3, 7), None), ((0,), None)],
    [((3,), None)],
    [((3,), {3: 1e-6})],
]


@pytest.mark.parametrize("failures", FAILURES, ids=["two", "one", "early"])
def test_controller_is_bitwise_with_the_optimiser_recorded(
        overlays, failures, monkeypatch):
    jov, tov = overlays
    rec = RecordedOptimiser()
    rec.record(monkeypatch)
    jctl, jout = _controller_run(jft, jov, failures)
    rec.replay(monkeypatch)
    tctl, tout = _controller_run(tft, tov, failures)
    assert rec.port_calls == rec.jax_calls
    assert tctl.alive == jctl.alive
    for (jx, jw, jsched), (tx, tw, tsched) in zip(jout, tout):
        np.testing.assert_array_equal(jx, tx)
        assert_same(jw, tw)
        assert_same(jsched, tsched)
    for a, b in zip(jctl.events, tctl.events):
        assert_same(a, b)
    ev = tctl.events[-1]
    assert ev.pricing_seconds == 1.0 and ev.redesign_seconds == 1.0


def test_controller_redesigns_after_failure(overlays):
    """The port's own optimiser on the CPU: the reference's test."""
    _, tov = overlays
    ctl = tft.FaultToleranceController(tov, kappa=1e6, device="cpu")
    state = {"x": torch.arange(10.0)[:, None]}
    new_state, w, _ = ctl.handle_failures((3, 7), state, step=10)
    assert new_state["x"].shape == (8, 1)
    mixing.validate_mixing(w)
    assert ctl.alive == (0, 1, 2, 4, 5, 6, 8, 9)
    np.testing.assert_allclose(new_state["x"].numpy().ravel(),
                               [0, 1, 2, 4, 5, 6, 8, 9])
    ev = ctl.events[-1]
    assert np.isfinite(ev.transition_tau) and ev.transition_tau > 0
    assert ev.cancelled_exchanges > 0
    assert ev.new_rho == mixing.rho(w)
    new_state, w2, _ = ctl.handle_failures((0,), new_state, step=20)
    assert new_state["x"].shape == (7, 1)
    mixing.validate_mixing(w2)


def test_controller_without_transition_pricing(overlays):
    jov, tov = overlays
    out = []
    for ft, ov in ((jft, jov), (tft, tov)):
        kw = {"device": "cpu"} if ft is tft else {}
        ctl = ft.FaultToleranceController(
            ov, kappa=1e6, price_transitions=False,
            clock=iter(range(100)).__next__, **kw)
        x = np.arange(10.0)[:, None]
        state = {"x": torch.from_numpy(x) if ft is tft else jnp.asarray(x)}
        _, w, _ = ctl.handle_failures((3,), state, step=1)
        jmixing.validate_mixing(w)
        ev = ctl.events[-1]
        out.append((ev.transition_tau, ev.cancelled_exchanges,
                    ev.pricing_seconds, ev.redesign_seconds))
    assert np.isnan(out[1][0]) and out[1][1] == 0
    assert out[1][2:] == out[0][2:] == (1, 1)
    with pytest.raises(RuntimeError, match="all agents failed"):
        tft.FaultToleranceController(
            tov, kappa=1e6, price_transitions=False, device="cpu"
        ).handle_failures(tuple(range(10)), {}, step=0)


def test_membership_surviving_overlay_is_the_reference(overlays):
    jov, tov = overlays
    a = jft.Membership(jov, (0, 2, 5, 7)).surviving_overlay()
    b = tft.Membership(tov, (0, 2, 5, 7)).surviving_overlay()
    assert a.agents == b.agents
    assert dict(a.paths) == dict(b.paths)
