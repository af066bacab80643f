"""The paper's gate on the port (``repro_torch.paper``) against the JAX
package's ``benchmarks/{common,fig5_training,priced_training}.py``, and
the port's FedDyn step against ``repro.core.dpsgd``.

Both gates run at 12 steps on the CPU, the port's from the JAX package's
initial parameters (carried across by ``models.convert.params_from_jax``)
and with the JAX designer's optimiser recorded
(``_torch_design.RecordedOptimiser``): every round's τ and the charged
wall-clock are then bitwise the reference's, and the losses agree at
rtol 1e-4 (float32 sums in another order, the trainer tests' tolerance).
The gate's arithmetic and its printed verdict are held line for line.
"""

import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.priced_training as jpt
from repro import compat as jcompat
from repro.core import dpsgd as jax_dpsgd
from repro.models import model as jax_model
from repro_torch.core import dpsgd
from repro_torch.core import priced_training as tpt
from repro_torch.models import convert
from repro_torch.paper import fig5_training as tfig5
from repro_torch.paper import priced_training as tgate
from repro_torch.paper import scenario as tscen
from repro_torch.tree import tree_leaves

from _torch_design import RecordedOptimiser
from _torch_parity import JCFG, TCFG, max_param_diff, ring, smoke_params, stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the JAX package's benchmarks/ (no package)
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jscen  # noqa: E402
from benchmarks import fig5_training as jfig5  # noqa: E402
from benchmarks import priced_training as jgate  # noqa: E402

STEPS = 12
# the trainer tests' tolerances (tests/test_torch_dpsgd.py)
LOSS_RTOL = 1e-4   # per-step mean loss
PARAM_ATOL = 1e-4  # final parameters; fp32 sums in another order only


@pytest.fixture(scope="module")
def gates():
    """``run(steps=12)`` of both packages: the JAX one recording its
    optimiser, the port's replaying it from the same initial parameters."""
    jcompat.ensure_x64()
    rec = RecordedOptimiser()
    with pytest.MonkeyPatch.context() as mp:
        rec.record(mp)
        jres = jfig5.run(steps=STEPS)
    init = jax.tree.map(
        np.asarray, jax_model.init(jfig5.SMALL_LM, jax.random.key(0)))
    inits = []

    def init_from_jax(cfg, generator, device=None):
        inits.append((cfg, generator))
        return convert.params_from_jax(init, cfg, device)

    with pytest.MonkeyPatch.context() as mp:
        rec.replay(mp)
        mp.setattr(tfig5, "model", types.SimpleNamespace(
            init=init_from_jax, loss=tfig5.model.loss))
        tres = tfig5.run(steps=STEPS, device="cpu")
    assert inits == [(tfig5.SMALL_LM, 0)] * len(tfig5.SCHEMES)
    assert rec.port_calls == rec.jax_calls
    return jres, tres


def test_scenario_and_model_are_the_references():
    assert tscen.NUM_AGENTS == jscen.NUM_AGENTS
    assert tscen.KAPPA == jscen.KAPPA
    assert tscen.CONSTANTS.__dict__ == jscen.CONSTANTS.__dict__
    assert tfig5.SCHEMES == jfig5.SCHEMES
    for f in jfig5.SMALL_LM.__dataclass_fields__:
        assert getattr(tfig5.SMALL_LM, f) == getattr(jfig5.SMALL_LM, f), f
    _, jov, jcats = jscen.paper_scenario()
    _, tov, tcats = tscen.paper_scenario()
    assert list(tov.paths.items()) == list(jov.paths.items())
    assert tcats.capacity == jcats.capacity
    assert (tgate.GATE_REDUCTION, tgate.LOSS_TOL, tgate.STEPS) == (
        jgate.GATE_REDUCTION, jgate.LOSS_TOL, jgate.STEPS)


@pytest.mark.parametrize("scheme", tfig5.SCHEMES)
def test_every_round_is_charged_the_references_tau(gates, scheme):
    j, t = gates[0][scheme], gates[1][scheme]
    t["log"].validate()
    assert (t["tau"], t["tau_bar"], t["rho"]) == (j["tau"], j["tau_bar"],
                                                   j["rho"])
    assert t["tau_model"] == j["tau_model"] == "static"
    assert len(t["log"].records) == len(j["log"].records) == STEPS
    for jr, tr in zip(j["log"].records, t["log"].records):
        assert (tr.tau, tr.wall_clock) == (jr.tau, jr.wall_clock)  # bitwise
        assert (tr.step, tr.design, tr.pricing) == (jr.step, jr.design,
                                                    jr.pricing)
        assert tr.tau == t["tau"]
    assert t["wall_clock"] == j["wall_clock"]
    assert t["steps"] == j["steps"]
    assert t["time_to_final"] == j["time_to_final"]


@pytest.mark.parametrize("scheme", tfig5.SCHEMES)
def test_losses_agree(gates, scheme):
    j, t = gates[0][scheme], gates[1][scheme]
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(t["final_loss"], j["final_loss"],
                               rtol=LOSS_RTOL)
    cons = [(r.consensus, q.consensus) for r, q in
            zip(t["log"].records, j["log"].records) if r.step % 10 == 0]
    np.testing.assert_allclose(*zip(*cons), rtol=1e-3)


def _verdict(main, module, res, capsys, monkeypatch, argv=()):
    """``main``'s exit code and printed lines on ``res``, the
    ``us_per_call`` field (a host time) blanked."""
    monkeypatch.setattr(module, "run", lambda steps, **kw: res)
    code = 0
    try:
        code = main(*argv) or 0
    except SystemExit as e:
        code = e.code
    lines = capsys.readouterr().out.splitlines()
    return code, [
        ",".join(l.split(",")[::2]) if l.startswith("priced_training,")
        else l for l in lines
    ]


def _fake(final_clique, final_fmmd, tau_clique=6801.84, tau_fmmd=755.76):
    """Results shaped as ``run()``'s for the two schemes the gate reads:
    losses falling linearly to the given final loss over 120 steps."""
    res = {}
    for name, final, tau in (("clique", final_clique, tau_clique),
                             ("fmmd-wp", final_fmmd, tau_fmmd)):
        log = tpt.PricedTrainLog()
        wall = 0.0
        for k in range(120):
            wall += tau
            log.records.append(tpt.RoundRecord(
                step=k, design=name, pricing="static", gossip_rounds=1,
                tau=tau, wall_clock=wall,
                loss=6.5 - (6.5 - final) * (k + 1) / 120))
        res[name] = dict(final_loss=log.losses[-1], log=log,
                         time_to_final=log.total_wall, tau_model="static")
    return res


@pytest.mark.parametrize("case", ["pass", "loss-gap", "reduction", "run"])
def test_gate_verdict_is_the_references(gates, case, capsys, monkeypatch):
    """The same results through both scripts' ``main``: the same curves,
    numbers, verdict and exit code."""
    res = {
        "pass": _fake(5.00, 5.01),
        "loss-gap": _fake(5.00, 5.05),
        "reduction": _fake(5.00, 5.01, tau_fmmd=3000.0),
        "run": gates[0],
    }[case]
    jcode, jlines = _verdict(jgate.main, jgate, res, capsys, monkeypatch)
    tcode, tlines = _verdict(tgate.main, tgate, res, capsys, monkeypatch,
                             argv=(["--device", "cpu"],))
    assert tlines == jlines
    assert (tcode or 0) == (jcode or 0)
    want = {"pass": 0, "loss-gap": 1, "reduction": 1}.get(case)
    if want is not None:
        assert (tcode or 0) == want
        assert ("GATE PASS" in tlines[-1]) == (want == 0)
    g = tgate.gate_numbers(res)
    assert f"time_reduction_ratio={g['reduction']:.3f};" in "".join(tlines)


def test_port_gate_numbers_on_its_own_run(gates):
    """The 12-step port run through the gate's arithmetic: the same
    equal-quality read as the reference's on its run, to the losses'
    tolerance (the reduction is τ_fmmd/τ_clique at equal steps here)."""
    jres, tres = gates
    tg = tgate.gate_numbers(tres)
    jg = tgate.gate_numbers(jres)
    np.testing.assert_allclose(tg["target"], jg["target"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg["loss_gap"], jg["loss_gap"], atol=1e-3)
    assert tg["t_clique"] in tres["clique"]["wall_clock"]
    assert tg["t_fmmd"] in tres["fmmd-wp"]["wall_clock"]


# ---------------------------------------------------------------------------
# FedDyn
# ---------------------------------------------------------------------------

ALPHA = 0.05
DPSGD_M, LR = 4, 0.05


def _jloss(p, b):
    return jax_model.loss(JCFG, p, {"tokens": b}, remat=False)[0]


def _tloss(p, b):
    from repro_torch.models import model

    return model.loss(TCFG, p, {"tokens": b}, remat=False)[0]


def _carry_diff(jc, tc):
    return max(max_param_diff(jc[0], tc[0]), max_param_diff(jc[1], tc[1]))


def test_feddyn_steps_match_jax():
    jp, tp = smoke_params(0)
    w = ring(DPSGD_M)
    data = stream(DPSGD_M)
    jstep = jax_dpsgd.make_feddyn_step(_jloss, LR, alpha=ALPHA)
    jparams = jax_dpsgd.replicate_for_agents(jp, DPSGD_M)
    jcarry = (jparams, jax_dpsgd.feddyn_init(jparams))
    tstep = dpsgd.make_feddyn_step(_tloss, LR, alpha=ALPHA)
    tparams = dpsgd.replicate_for_agents(tp, DPSGD_M)
    tcarry = (tparams, dpsgd.feddyn_init(tparams))
    plan = dpsgd.mixing_plan(w, "cpu")
    for k in range(3):
        batch = data.stacked_batch(k, 2)
        jcarry, jl = jstep(jcarry, jnp.asarray(batch), jnp.asarray(w),
                           jnp.asarray(k))
        tcarry, tl = tstep(tcarry, batch, plan, k)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert _carry_diff(jcarry, tcarry) <= PARAM_ATOL
    # h moved: the correction is carried, not reset
    assert max(float(h.abs().max()) for h in tree_leaves(tcarry[1])) > 0
    with pytest.raises(TypeError, match="MixingPlan"):
        tstep(tcarry, data.stacked_batch(0, 2), w, 0)


def test_feddyn_init_is_zeros_of_the_params_shape():
    _, tp = smoke_params(0)
    params = dpsgd.replicate_for_agents(tp, 3)
    h = dpsgd.feddyn_init(params)
    for p, z in zip(tree_leaves(params), tree_leaves(h)):
        assert z.shape == p.shape and z.dtype == p.dtype
        assert not bool(z.any())


def test_feddyn_through_train_priced_with_extract_params():
    jp, tp = smoke_params(1)
    w = ring(DPSGD_M)
    data = stream(DPSGD_M)
    jparams = jax_dpsgd.replicate_for_agents(jp, DPSGD_M)
    jcarry, jlog = jpt.train_priced(
        (jparams, jax_dpsgd.feddyn_init(jparams)),
        jax_dpsgd.make_feddyn_step(_jloss, LR, alpha=ALPHA),
        lambda k: jnp.asarray(data.stacked_batch(k, 2)), jnp.asarray(w),
        jpt.StaticTau(7.25), 4, log_every=1, extract_params=lambda c: c[0],
    )
    tparams = dpsgd.replicate_for_agents(tp, DPSGD_M)
    tcarry, tlog = tpt.train_priced(
        (tparams, dpsgd.feddyn_init(tparams)),
        dpsgd.make_feddyn_step(_tloss, LR, alpha=ALPHA),
        lambda k: data.stacked_batch(k, 2), w, tpt.StaticTau(7.25), 4,
        log_every=1, extract_params=lambda c: c[0], device="cpu",
    )
    tlog.validate()
    assert [(r.tau, r.wall_clock) for r in tlog.records] == [
        (r.tau, r.wall_clock) for r in jlog.records]
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        [r.consensus for r in tlog.records],
        [r.consensus for r in jlog.records], rtol=1e-3)
    assert _carry_diff(jcarry, tcarry) <= PARAM_ATOL
    assert isinstance(tcarry, tuple) and len(tcarry) == 2
