"""Port `optim/` (sgd, adamw, schedule) against the JAX package's.

The same numpy-seeded trees go through both. The reference's update runs
under `jax.jit`, as the launcher's step runs it: XLA compiles each
`a·b + c` of `sgd.update` into one fused multiply-add, which the port's
`torch.add(..., alpha=)` matches, so SGD is held at 2e-5 in float32 and
bitwise in bfloat16. The schedules are host floats: bitwise against the
`jnp` float32 values (called with a Python int, as a host loop calls
them), `cosine` within one float32 ulp (the port rounds a float64 `cos`
to float32, which XLA's float32 `cos` is not bound to match). Under `jit` XLA turns `cosine`'s division by the
constant `total_steps − warmup` into a product with its reciprocal, one
more ulp of `prog`; the other schedules are bitwise under `jit` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.optim import sgd as jsgd
from repro_torch.optim import adamw, schedule, sgd

FP32_TOL = 2e-5
SHAPES = {"w": (4, 33, 7), "b": (4, 7), "blocks": {"k": (4, 2, 5, 3)}}


def _tree(rng, dtype):
    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return rng.standard_normal(node).astype(np.float32)

    return build(SHAPES)


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _torch(tree, dtype):
    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return torch.from_numpy(node).to(dtype)

    return build(tree)


def _pairs(jtree, ttree):
    jl = jax.tree.leaves(jtree)          # sorted keys
    tl = [ttree["b"], ttree["blocks"]["k"], ttree["w"]]
    return [
        (np.asarray(a.astype(jnp.float32)), b.to(torch.float32).numpy())
        for a, b in zip(jl, tl)
    ]


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("lr", [0.01, 0.05, 0.0123456])
@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("grad_fp32", [False, True], ids=["g_like_p", "g_fp32"])
def test_sgd_update_matches_jax(lr, dt, grad_fp32):
    jdt, tdt = dt
    rng = np.random.default_rng(3)
    p, m, g = (_tree(rng, None) for _ in range(3))
    gj, gt = (jnp.float32, torch.float32) if grad_fp32 else dt
    jp, jst = jax.jit(jsgd.update)(
        _jax(g, gj), {"momentum": _jax(m, jdt)}, _jax(p, jdt),
        jnp.asarray(lr, jnp.float32),
    )
    t_params, t_mom = _torch(p, tdt), _torch(m, tdt)
    tp, tst = sgd.update(_torch(g, gt), {"momentum": t_mom}, t_params, lr)
    for got_pairs in (_pairs(jp, tp), _pairs(jst["momentum"], tst["momentum"])):
        for a, b in got_pairs:
            if tdt == torch.bfloat16:
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, rtol=FP32_TOL, atol=FP32_TOL)
    # the inputs are not written
    assert torch.equal(t_params["w"], _torch(p, tdt)["w"])
    assert torch.equal(t_mom["w"], _torch(m, tdt)["w"])
    assert tst["momentum"]["w"].dtype == tdt


def test_sgd_init_and_momentum_dtype():
    params = {"a": torch.ones(2, 3, dtype=torch.bfloat16)}
    st = sgd.init(params)
    assert st["momentum"]["a"].dtype == torch.bfloat16
    assert not st["momentum"]["a"].any()
    assert sgd.init(params, torch.float32)["momentum"]["a"].dtype == torch.float32


def test_sgd_refuses_a_tensor_lr():
    p = {"a": torch.ones(3)}
    with pytest.raises(TypeError):
        sgd.update(p, sgd.init(p), p, torch.tensor(0.1))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_update_matches_jax(weight_decay):
    rng = np.random.default_rng(5)
    p = _tree(rng, None)
    jp, tp = _jax(p, jnp.float32), _torch(p, torch.float32)
    jst, tst = jadamw.init(jp), adamw.init(tp)
    jupd = jax.jit(
        lambda g, s, q, lr: jadamw.update(g, s, q, lr, weight_decay=weight_decay)
    )
    for step in range(3):
        g = _tree(rng, None)
        jp, jst = jupd(_jax(g, jnp.float32), jst, jp, jnp.asarray(1e-2))
        tp, tst = adamw.update(
            _torch(g, torch.float32), tst, tp, 1e-2, weight_decay=weight_decay
        )
        assert tst["count"] == int(jst["count"]) == step + 1
        for tree_j, tree_t in ((jp, tp), (jst["m"], tst["m"]), (jst["v"], tst["v"])):
            for a, b in _pairs(tree_j, tree_t):
                np.testing.assert_allclose(b, a, rtol=FP32_TOL, atol=FP32_TOL)


STEPS = list(range(0, 40)) + [59, 60, 61, 119, 120, 121, 10**6]


@pytest.mark.parametrize(
    "name", ["constant", "step_decay", "paper_schedule", "cosine",
             "cosine_warmup", "cosine_short"],
)
def test_schedules_match_jnp_float32(name):
    make = {
        "constant": lambda m: m.constant(0.1),
        "step_decay": lambda m: m.step_decay([(5, 0.3), (17, 0.07), (30, 0.011)]),
        "paper_schedule": lambda m: m.paper_schedule(2),
        "cosine": lambda m: m.cosine(0.05, 37),
        "cosine_warmup": lambda m: m.cosine(0.1, 50, warmup=7),
        "cosine_short": lambda m: m.cosine(3e-4, 3, warmup=1),
    }[name]
    jfn, tfn = make(jschedule), make(schedule)
    jit_fn = jax.jit(jfn)
    for step in STEPS:
        got = tfn(step)
        assert isinstance(got, float)
        want = np.asarray(jfn(step))
        assert want.dtype == np.float32
        if name.startswith("cosine"):
            assert abs(np.float32(got) - want) <= np.spacing(want), (step, got, want)
        else:
            assert np.float32(got) == want and got == float(want), (step, got, want)
            traced = np.asarray(jit_fn(jnp.asarray(step, jnp.int32)))
            assert got == float(traced), (step, got, traced)
