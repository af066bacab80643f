"""The runtime slice end to end, against the JAX package: the smoke-size
model (fp32), m = 8 agents on roofnet_like(seed=0)'s 8 lowest-degree
nodes, trained by D-PSGD over the design service's W while
``examples/elastic_failover.py``'s stream (a link sag, two departures —
the first during a pricing outage —, a join, the recovery) re-designs W,
with ``shrink_state``/``grow_state`` re-mapping the stacked parameters
after each membership change. The reference (``repro.core``,
``repro.runtime``, engine "batched") and the port (``repro_torch``,
engine "torch" on the CPU) run side by side, a few steps between events:
after every event the records are equal (τ at rtol 1e-9) and the
parameters agree to PARAM_ATOL, the losses to LOSS_RTOL, as
tests/test_torch_dpsgd.py holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.net as jnet
import repro_torch.net as tnet
from _torch_parity import JCFG, TCFG, max_param_diff, smoke_params, stream
from repro import compat as jcompat
from repro.core import dpsgd as jax_dpsgd
from repro.models import model as jax_model
from repro.runtime import compression as jc
from repro.runtime import design_service as jds
from repro.runtime import events as jev
from repro.runtime import fault_tolerance as jft
from repro.runtime import faultinject as jfi
from repro_torch.core import dpsgd
from repro_torch.models import model
from repro_torch.runtime import compression as tc
from repro_torch.runtime import design_service as tds
from repro_torch.runtime import events as tev
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import faultinject as tfi


@pytest.fixture(autouse=True, scope="module")
def _x64():
    """float64 on in JAX for this file's tests (as in every port test),
    and back as it was after them."""
    was = jcompat.x64_enabled()
    jcompat.ensure_x64()
    yield
    jax.config.update("jax_enable_x64", was)


M, STEPS, LR = 8, 2, 0.05
LOSS_RTOL = 1e-4   # per-step mean loss
PARAM_ATOL = 1e-4  # parameters; fp32 sums in another order only
RTOL = 1e-9        # τ: the torch engine against "batched"
OUTAGE_AT = 2.0


def _jloss(p, b):
    return jax_model.loss(JCFG, p, {"tokens": b}, remat=False)[0]


def _tloss(p, b):
    return model.loss(TCFG, p, {"tokens": b}, remat=False)[0]


def _events(ev, svc, ov):
    worst = sorted(svc._binc.edges)[:3]
    free = next(n for n in sorted(ov.underlay.graph.nodes)
                if n not in set(ov.agents))
    return [
        ev.LinkStateChange(time=1.0, scales={e: 0.3 for e in worst}),
        ev.AgentLeave(time=2.0, agent=1),
        ev.AgentLeave(time=3.0, agent=5),
        ev.AgentJoin(time=4.0, node=free),
        ev.LinkStateChange(time=5.0, scales={e: 1.0 for e in worst}),
    ]


def _remap(ft, params, ev, before, svc):
    """The example's re-map of the stacked state to the new membership."""
    if type(ev).__name__ == "AgentLeave" and svc.members != before:
        keep = tuple(p for p, h in enumerate(before)
                     if h in set(svc.members))
        return ft.shrink_state(params, keep, len(before))
    if type(ev).__name__ == "AgentJoin" and svc.members != before:
        return ft.grow_state(params, svc.num_agents)
    return params


def _overlay(net):
    und = net.roofnet_like(seed=0)
    return net.build_overlay(und, net.lowest_degree_nodes(und, M))


@pytest.fixture(scope="module")
def elastic_run():
    """Both packages through the whole stream; per segment (the initial
    membership, then after each event): (records, m, losses, params)."""
    jp, tp = smoke_params(0)
    jparams = jax_dpsgd.replicate_for_agents(jp, M)
    tparams = dpsgd.replicate_for_agents(tp, M)
    kappa = tc.compressed_kappa(tp, "int8")
    assert kappa == jc.compressed_kappa(jp, "int8")
    jov, tov = _overlay(jnet), _overlay(tnet)
    jsvc = jds.DesignService(jov, kappa, jds.ServiceConfig(
        design_iterations=12))
    tsvc = tds.DesignService(tov, kappa, tds.ServiceConfig(
        design_iterations=12, engine="torch"), device="cpu")
    jstep = jax_dpsgd.make_dpsgd_step(_jloss, LR)
    tstep = dpsgd.make_dpsgd_step(_tloss, LR)
    data = stream(M)
    segments = []
    k = 0
    jevents, tevents = _events(jev, jsvc, jov), _events(tev, tsvc, tov)
    for seg in range(len(jevents) + 1):
        m = tsvc.num_agents
        plan = dpsgd.mixing_plan(tsvc.design, "cpu")
        jw = jnp.asarray(jsvc.design)
        losses = []
        for _ in range(STEPS):
            batch = data.stacked_batch(k, 1)[:m]
            jparams, jl = jstep(jparams, jnp.asarray(batch), jw,
                                jnp.asarray(k))
            tparams, tl = tstep(tparams, batch, plan, k)
            losses.append((float(jl), float(tl)))
            k += 1
        segments.append({"m": m, "losses": losses,
                         "diff": max_param_diff(jparams, tparams),
                         "jdesign": jsvc.design, "tdesign": tsvc.design})
        if seg == len(jevents):
            break
        recs = []
        for svc, fi, ft, ev, params in (
                (jsvc, jfi, jft, jevents[seg], jparams),
                (tsvc, tfi, tft, tevents[seg], tparams)):
            if ev.time == OUTAGE_AT:
                svc.injector = fi.FaultInjector(
                    fi.FaultPlan(seed=0, rate=1.0, modes=("raise",)),
                    clock=svc.clock)
            before = svc.members
            recs.append(svc.process(ev))
            svc.injector = None
            params = _remap(ft, params, ev, before, svc)
            if svc is jsvc:
                jparams = params
            else:
                tparams = params
        segments[-1]["records"] = recs
        segments[-1]["after"] = (jsvc.num_agents, tsvc.num_agents,
                                 jsvc.members, tsvc.members)
        segments[-1]["diff_after_remap"] = max_param_diff(jparams, tparams)
        segments[-1]["shapes"] = (
            {p.shape[0] for p in jax.tree.leaves(jparams)},
            {p.shape[0] for p in jax.tree.leaves(tparams)})
    return segments


SEGMENTS = range(6)


@pytest.mark.parametrize("seg", SEGMENTS)
def test_training_agrees_in_each_segment(elastic_run, seg):
    s = elastic_run[seg]
    assert s["m"] == (8, 8, 7, 6, 7, 7)[seg]
    for jl, tl in s["losses"]:
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert s["diff"] <= PARAM_ATOL
    assert np.array_equal(s["jdesign"], s["tdesign"])


@pytest.mark.parametrize("seg", SEGMENTS[:-1])
def test_each_event_decides_as_the_reference(elastic_run, seg):
    s = elastic_run[seg]
    j, t = s["records"]
    for f in ("seq", "time", "event", "decision", "tier", "retries",
              "faults"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.tau == pytest.approx(j.tau, rel=RTOL)
    jm, tm, jmembers, tmembers = s["after"]
    assert jm == tm and jmembers == tmembers
    assert s["shapes"][0] == s["shapes"][1] == {tm}
    assert s["diff_after_remap"] <= PARAM_ATOL
    assert (t.decision, t.tier) == (
        ("adopt", "normal"), ("incumbent-keep", "incumbent-keep"),
        ("redesign", "normal"), ("redesign", "normal"),
        ("adopt", "normal"))[seg]
