"""Port `core/dpsgd.py` against the JAX package: 3 D-PSGD steps of the
smoke-size model, m = 4 agents, ring W, the same tokens (fp32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dpsgd as jax_dpsgd
from repro.models import model as jax_model
from repro_torch.core import dpsgd
from repro_torch.kernels import ops
from repro_torch.models import model
from repro_torch.tree import tree_leaves, tree_map

from _torch_parity import JCFG, TCFG, max_param_diff, ring, smoke_params, stream

M, STEPS, LR = 4, 3, 0.05
LOSS_RTOL = 1e-4   # per-step mean loss
PARAM_ATOL = 1e-4  # final parameters; fp32 sums in another order only


def _jloss(p, b):
    return jax_model.loss(JCFG, p, {"tokens": b}, remat=False)[0]


def _tloss(p, b):
    return model.loss(TCFG, p, {"tokens": b}, remat=False)[0]


def _run_torch(tp, w, **kw):
    step = dpsgd.make_dpsgd_step(_tloss, LR, **kw)
    params = dpsgd.replicate_for_agents(tp, M)
    plan = dpsgd.mixing_plan(w, "cpu")
    data = stream(M)
    losses = []
    for k in range(STEPS):
        params, loss = step(params, data.stacked_batch(k, 2), plan, k)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize(
    "kw", [{}, {"mix_first": True}, {"prox_mu": 0.1},
           {"mix_first": True, "prox_mu": 0.1}],
    ids=["default", "mix_first", "prox", "mix_first_prox"],
)
def test_steps_match_jax(kw):
    jp, tp = smoke_params(0)
    w = ring(M)
    jstep = jax_dpsgd.make_dpsgd_step(_jloss, LR, **kw)
    jparams = jax_dpsgd.replicate_for_agents(jp, M)
    data = stream(M)
    jlosses = []
    for k in range(STEPS):
        jparams, loss = jstep(
            jparams, jnp.asarray(data.stacked_batch(k, 2)), jnp.asarray(w),
            jnp.asarray(k),
        )
        jlosses.append(float(loss))
    tparams, tlosses = _run_torch(tp, w, **kw)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert max_param_diff(jparams, tparams) <= PARAM_ATOL
    np.testing.assert_allclose(
        float(dpsgd.consensus_distance(tparams)),
        float(jax_dpsgd.consensus_distance(jparams)), rtol=1e-3,
    )


def test_prox_mu_zero_is_bitwise_plain():
    _, tp = smoke_params(0)
    w = ring(M)
    plain, l0 = _run_torch(tp, w)
    prox0, l1 = _run_torch(tp, w, prox_mu=0.0)
    assert l0 == l1
    for a, b in zip(tree_leaves(plain), tree_leaves(prox0)):
        assert torch.equal(a, b)


def test_default_step_is_one_fused_call_per_leaf(monkeypatch):
    """Eq. (2) goes through `ops.mixing_sgd_combine_stacked`, once per
    parameter leaf, and through no dense mixing."""
    _, tp = smoke_params(0)
    calls = []
    real = ops.mixing_sgd_combine_stacked

    def spy(x, idx, weights, g, *, lr):
        calls.append((tuple(x.shape), lr))
        return real(x, idx, weights, g, lr=lr)

    monkeypatch.setattr(ops, "mixing_sgd_combine_stacked", spy)
    monkeypatch.setattr(
        dpsgd, "mix_params",
        lambda *a, **k: pytest.fail("dense mixing on the default path"),
    )
    step = dpsgd.make_dpsgd_step(_tloss, lambda k: LR / (k + 1))
    params = dpsgd.replicate_for_agents(tp, M)
    plan = dpsgd.mixing_plan(ring(M), "cpu")
    step(params, stream(M).stacked_batch(0, 2), plan, 1)
    with pytest.raises(TypeError, match="MixingPlan"):
        step(params, stream(M).stacked_batch(0, 2), ring(M), 1)
    assert len(calls) == len(tree_leaves(tp))
    assert all(shape[0] == M and lr == LR / 2 for shape, lr in calls)


def test_fused_update_equals_plain_update():
    _, tp = smoke_params(1)
    params = dpsgd.replicate_for_agents(tp, M)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(
        lambda p: p + 0.1 * torch.randn(p.shape, generator=gen), params
    )
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    plan = dpsgd.mixing_plan(ring(M), "cpu")
    fused = dpsgd.fused_update(params, grads, plan, LR)
    plain = dpsgd.plain_update(params, grads, plan.w, LR)
    for a, b in zip(tree_leaves(fused), tree_leaves(plain)):
        # fp32, three-term sums in two orders
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert a.shape == b.shape


def test_agent_grads_match_vmapped_jax_grads():
    jp, tp = smoke_params(0)
    batch = stream(M).stacked_batch(0, 2)
    jl, jg = jax.vmap(jax.value_and_grad(_jloss))(
        jax_dpsgd.replicate_for_agents(jp, M), jnp.asarray(batch)
    )
    tl, tg = dpsgd.agent_grads(
        _tloss, dpsgd.replicate_for_agents(tp, M), torch.from_numpy(batch)
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    assert max_param_diff(jg, tg) <= PARAM_ATOL


def test_train_log_matches_jax():
    jp, tp = smoke_params(0)
    w = ring(M)
    data = stream(M)
    jparams, jlog = jax_dpsgd.train(
        jax_dpsgd.replicate_for_agents(jp, M),
        jax_dpsgd.make_dpsgd_step(_jloss, LR),
        lambda k: jnp.asarray(data.stacked_batch(k, 2)), w, STEPS,
        tau_per_iteration=2.0, log_every=2,
    )
    tparams, tlog = dpsgd.train(
        dpsgd.replicate_for_agents(tp, M),
        dpsgd.make_dpsgd_step(_tloss, LR),
        lambda k: data.stacked_batch(k, 2), w, STEPS,
        tau_per_iteration=2.0, log_every=2, device="cpu",
    )
    assert tlog.steps == jlog.steps and tlog.wall_time == jlog.wall_time
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlog.consensus, jlog.consensus, rtol=1e-3)


def test_replicate_is_contiguous_and_independent():
    _, tp = smoke_params(0)
    stacked = dpsgd.replicate_for_agents(tp, 3)
    for p, s in zip(tree_leaves(tp), tree_leaves(stacked)):
        assert s.shape == (3, *p.shape) and s.is_contiguous()
        assert torch.equal(s[2], p)
