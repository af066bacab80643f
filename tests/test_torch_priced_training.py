"""The slice as a whole: `train_priced` with `StaticTau` and one scheduled
redesign, run in the JAX package and in the port on the same parameters and
tokens (fp32, CPU). τ and the charged wall-clock are host float64 in both
and must be bitwise equal; losses agree to 1e-4; logs load across packages.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dpsgd as jax_dpsgd
from repro.core import priced_training as jax_pt
from repro.models import model as jax_model
from repro_torch.core import dpsgd
from repro_torch.core import priced_training as pt
from repro_torch.models import model
from repro_torch.core import mixing

from _torch_parity import JCFG, TCFG, max_param_diff, ring, smoke_params, stream

M, STEPS, LR = 4, 5, 0.05
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
CONSENSUS_RTOL = 1e-3  # a sum of squared 1e-7-level differences


def _both(strategy_rounds=1, redesign_at=3, log_every=2, compute=0.0):
    jp, tp = smoke_params(0)
    w0, w1 = ring(M), mixing.ideal_matrix(M)
    data = stream(M)

    jstep = jax_dpsgd.make_dpsgd_step(
        lambda p, b: jax_model.loss(JCFG, p, {"tokens": b}, remat=False)[0], LR
    )
    jparams, jlog = jax_pt.train_priced(
        jax_dpsgd.replicate_for_agents(jp, M), jstep,
        lambda k: jnp.asarray(data.stacked_batch(k, 2)), w0,
        jax_pt.StaticTau(3.7, label="ring"), STEPS,
        strategy=jax_pt.GossipStrategy(rounds=strategy_rounds),
        design_label="ring",
        redesigns={redesign_at: ("clique", w1, jax_pt.StaticTau(11.3))},
        log_every=log_every, compute_time_per_step=compute,
    )
    tstep = dpsgd.make_dpsgd_step(
        lambda p, b: model.loss(TCFG, p, {"tokens": b}, remat=False)[0], LR
    )
    tparams, tlog = pt.train_priced(
        dpsgd.replicate_for_agents(tp, M), tstep,
        lambda k: data.stacked_batch(k, 2), w0,
        pt.StaticTau(3.7, label="ring"), STEPS,
        strategy=pt.GossipStrategy(rounds=strategy_rounds),
        design_label="ring",
        redesigns={redesign_at: ("clique", w1, pt.StaticTau(11.3))},
        log_every=log_every, compute_time_per_step=compute, device="cpu",
    )
    return (jparams, jlog), (tparams, tlog)


@pytest.mark.parametrize(
    "rounds,compute", [(1, 0.0), (2, 0.0), (1, 0.25)],
    ids=["one-shot", "gossip-x2", "compute-time"],
)
def test_train_priced_matches_jax(rounds, compute):
    (jparams, jlog), (tparams, tlog) = _both(rounds, compute=compute)
    tlog.validate()
    assert len(tlog.records) == STEPS
    for jr, tr in zip(jlog.records, tlog.records):
        # host float64 in both packages: bitwise
        assert tr.tau == jr.tau and tr.wall_clock == jr.wall_clock
        assert (tr.step, tr.design, tr.pricing, tr.gossip_rounds) == (
            jr.step, jr.design, jr.pricing, jr.gossip_rounds)
        np.testing.assert_allclose(tr.loss, jr.loss, rtol=LOSS_RTOL)
        assert np.isnan(tr.consensus) == np.isnan(jr.consensus)
        if not np.isnan(jr.consensus):
            np.testing.assert_allclose(
                tr.consensus, jr.consensus, rtol=CONSENSUS_RTOL)
    assert [r.design for r in tlog.records] == ["ring"] * 3 + ["clique"] * 2
    assert tlog.records[3].tau == rounds * 11.3 + compute
    assert tlog.total_wall == jlog.total_wall
    assert max_param_diff(jparams, tparams) <= PARAM_ATOL


def test_json_logs_load_across_packages():
    (_, jlog), (_, tlog) = _both()
    from_port = jax_pt.PricedTrainLog.from_json(tlog.to_json())
    from_jax = pt.PricedTrainLog.from_json(jlog.to_json())
    from_port.validate()
    from_jax.validate()
    assert json.loads(tlog.to_json()).keys() == json.loads(jlog.to_json()).keys()
    assert [r.wall_clock for r in from_port.records] == tlog.wall_clock
    assert [r.wall_clock for r in from_jax.records] == jlog.wall_clock
    assert from_jax.time_to_loss(-1.0) == float("inf")
    assert from_jax.time_to_loss(1e9) == jlog.records[0].wall_clock
    for a, b in zip(from_port.records, tlog.records):
        assert a.loss == b.loss and a.design == b.design


def test_intervene_and_plan_built_once_per_design(monkeypatch):
    """`intervene` can swap the design; the device tables are rebuilt only
    then (once at the start, once at the switch), never per step."""
    _, tp = smoke_params(0)
    built = []
    real = pt.mixing_plan
    monkeypatch.setattr(
        pt, "mixing_plan", lambda w, dev: built.append(1) or real(w, dev)
    )
    data = stream(M)

    def intervene(k, carry):
        if k == 2:
            return carry, ("late", mixing.ideal_matrix(M), pt.StaticTau(1.0))
        return carry, None

    step = dpsgd.make_dpsgd_step(
        lambda p, b: model.loss(TCFG, p, {"tokens": b}, remat=False)[0], LR
    )
    _, log = pt.train_priced(
        dpsgd.replicate_for_agents(tp, M), step,
        lambda k: data.stacked_batch(k, 2), ring(M), pt.StaticTau(2.0), 4,
        intervene=intervene, log_every=0, device="cpu",
    )
    assert len(built) == 2
    assert [r.tau for r in log.records] == [2.0, 2.0, 1.0, 1.0]
    assert all(np.isnan(r.consensus) for r in log.records)


@pytest.mark.parametrize("case", ["rounds", "steps", "corrupt"])
def test_validation_errors(case):
    if case == "rounds":
        with pytest.raises(ValueError):
            pt.GossipStrategy(rounds=0)
    elif case == "steps":
        with pytest.raises(ValueError):
            pt.train_priced({}, None, None, np.eye(2), pt.StaticTau(1.0), -1,
                            device="cpu")
    else:
        log = pt.PricedTrainLog([
            pt.RoundRecord(0, "d", "static", 1, 1.0, 1.0, 0.5),
            pt.RoundRecord(1, "d", "static", 1, 1.0, 2.5, 0.4),
        ])
        with pytest.raises(ValueError, match="running"):
            log.validate()
        assert pt.GossipStrategy(rounds=3).name == "gossip-x3"
        assert pt.GossipStrategy().name == "one-shot"
