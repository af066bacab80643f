"""The port's `models/moe.py` against the JAX package's on the CPU: the same
parameters and tokens (made with numpy from fixed seeds) through both
`apply` (outputs and both aux losses, dropping and droppless capacities),
the dense oracle, forced ties, the loop-over-experts branch, gradients
through dispatch and combine, and one bf16 case. Tolerances are the JAX
package's: 2e-5 fp32, 2e-2 bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe

FP32_TOL = 2e-5
BF16_TOL = 2e-2
D, F = 16, 32


def _spec(e, k, cf):
    return (jax_moe.MoESpec(D, F, e, k, cf), moe.MoESpec(D, F, e, k, cf))


def _params(e, seed, scale=1.0):
    """One set of expert and router weights as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "router": {"kernel": rng.standard_normal((D, e)) * scale},
        "gate": rng.standard_normal((e, D, F)) * D**-0.5,
        "up": rng.standard_normal((e, D, F)) * D**-0.5,
        "down": rng.standard_normal((e, F, D)) * F**-0.5,
    }


def _both(tree, dtype=np.float32):
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)), tree)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, dtype)), tree)
    return jp, tp


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(
        np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=tol, atol=tol, err_msg=what)


CASES = [
    # (b, s, E, k, cf): dropping capacities first
    (2, 16, 4, 2, 1.0),
    (2, 16, 4, 2, 1.25),
    (1, 32, 8, 2, 1.25),
    (3, 8, 4, 1, 1.0),
    (2, 24, 8, 2, 4.0),     # = E / k: droppless
    (1, 16, 4, 2, 8.0),     # the smoke configs' factor
    (2, 8, 2, 1, 2.0),
    (1, 1, 8, 2, 1.25),     # one token (a decode step): capacity = k
]


@pytest.mark.parametrize("b,s,e,k,cf", CASES)
def test_apply_matches_jax(b, s, e, k, cf):
    jspec, tspec = _spec(e, k, cf)
    jp, tp = _both(_params(e, seed=e + s))
    x = _x(b, s, seed=b * 100 + s)
    y, aux = jax.jit(lambda p, xx: jax_moe.apply(p, xx, jspec, jnp.float32))(
        jp, jnp.asarray(x))
    ty, taux = moe.apply(tp, torch.from_numpy(x), tspec, torch.float32)
    assert ty.shape == (b, s, D) and ty.dtype == torch.float32
    _close(ty, y, FP32_TOL, "y")
    assert taux.keys() == aux.keys()
    for name in aux:
        _close(taux[name], aux[name], FP32_TOL, name)
    # the dropping cases do drop (and the droppless ones do not)
    cap = moe.capacity(s, tspec)
    _, _, _, idx = moe.route(tp, torch.from_numpy(x), tspec)
    _, slot_for_choice = moe.dispatch_indices(idx, cap, e)
    dropped = int((slot_for_choice == e * cap).sum())
    assert (dropped > 0) == (cf < e / k and s > 1), dropped


@pytest.mark.parametrize("b,s,e,k", [(2, 16, 4, 2), (1, 24, 8, 2),
                                     (3, 8, 2, 1)])
def test_dense_reference_when_droppless(b, s, e, k):
    """As tests/test_moe.py: with a large capacity `apply` is the dense
    oracle; the port's oracle also equals the reference's."""
    jspec, tspec = _spec(e, k, float(e * 4))
    jp, tp = _both(_params(e, seed=7 + e))
    x = _x(b, s, seed=11 + s)
    ty, _ = moe.apply(tp, torch.from_numpy(x), tspec, torch.float32)
    tref = moe.apply_dense_reference(tp, torch.from_numpy(x), tspec,
                                     torch.float32)
    jref = jax_moe.apply_dense_reference(jp, jnp.asarray(x), jspec,
                                         jnp.float32)
    _close(ty, tref, FP32_TOL, "apply vs the port's oracle")
    _close(tref, jref, FP32_TOL, "the port's oracle vs the reference's")


@pytest.mark.parametrize("e,k,cf", [(4, 2, 1.25), (8, 2, 4.0), (4, 1, 1.0)])
def test_forced_ties_pick_the_lowest_experts(e, k, cf):
    """A zero router makes every probability equal: both packages must
    choose experts 0 .. k-1 for every token (jax.lax.top_k's tie order),
    and drop the same choices where the capacity binds."""
    jspec, tspec = _spec(e, k, cf)
    tree = _params(e, seed=3)
    tree["router"]["kernel"] = np.zeros((D, e))
    jp, tp = _both(tree)
    x = _x(2, 16, seed=5)
    _, _, gates, idx = moe.route(tp, torch.from_numpy(x), tspec)
    assert idx.tolist() == [[list(range(k))] * 16] * 2
    _, jidx = jax.lax.top_k(jnp.full((2, 16, e), 1.0 / e), k)
    assert np.array_equal(np.asarray(jidx), idx.numpy())
    np.testing.assert_array_equal(gates.numpy(), np.full((2, 16, k), 1.0 / k,
                                                         np.float32))
    y, aux = jax_moe.apply(jp, jnp.asarray(x), jspec, jnp.float32)
    ty, taux = moe.apply(tp, torch.from_numpy(x), tspec, torch.float32)
    _close(ty, y, FP32_TOL, "y")
    for name in aux:
        _close(taux[name], aux[name], FP32_TOL, name)


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_loop_over_experts_equals_vectorized(monkeypatch, cf):
    """The branch the reference takes above cap·d_ff = 128 Mi (forced here
    by a threshold of 0) gives the vectorized branch's result, and the
    reference's."""
    jspec, tspec = _spec(4, 2, cf)
    jp, tp = _both(_params(4, seed=9))
    x = torch.from_numpy(_x(2, 16, seed=13))
    vec, _ = moe.apply(tp, x, tspec, torch.float32)
    calls = []
    real_stack = torch.stack
    monkeypatch.setattr(moe, "LOOP_EXPERTS_ABOVE", 0)
    monkeypatch.setattr(moe.torch, "stack",
                        lambda *a, **kw: calls.append(1) or real_stack(*a, **kw))
    loop, _ = moe.apply(tp, x, tspec, torch.float32)
    monkeypatch.undo()
    assert calls == [1]
    _close(loop, vec, FP32_TOL, "loop vs vectorized")
    y, _ = jax_moe.apply(jp, jnp.asarray(x.numpy()), jspec, jnp.float32)
    _close(loop, y, FP32_TOL, "loop vs the reference")


@pytest.mark.parametrize("e,k,cf", [(2, 1, 4.0), (4, 2, 1.25), (4, 2, 8.0)])
def test_gradients_match_jax(e, k, cf):
    """Gradients of one scalar (the output's squares and both aux losses)
    through routing, dispatch and combine, w.r.t. every weight and the
    input, equal `jax.grad`'s (as tests/test_moe.py:46, held to values)."""
    jspec, tspec = _spec(e, k, cf)
    tree = _params(e, seed=21)
    jp, tp = _both(tree)
    x = _x(2, 8, seed=22)

    def jloss(p, xx):
        y, aux = jax_moe.apply(p, xx, jspec, jnp.float32)
        return (jnp.sum(y**2) + aux["load_balance_loss"]
                + aux["router_z_loss"])

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {"router": tp["router"]["kernel"], "gate": tp["gate"],
              "up": tp["up"], "down": tp["down"]}
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply(tp, tx, tspec, torch.float32)
    loss = (y**2).sum() + aux["load_balance_loss"] + aux["router_z_loss"]
    loss.backward()
    _close(tx.grad, jgx, FP32_TOL, "x")
    want = {"router": jg["router"]["kernel"], "gate": jg["gate"],
            "up": jg["up"], "down": jg["down"]}
    for name, t in leaves.items():
        assert float(t.grad.abs().sum()) > 0, name
        _close(t.grad, want[name], FP32_TOL, name)


def test_bf16_matches_jax():
    """bf16 parameters and compute (the served dtype), a dropping
    capacity: outputs at 2e-2, aux at 2e-2 (float32 router in both)."""
    jspec, tspec = _spec(8, 2, 1.25)
    tree = _params(8, seed=31)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    x = jnp.asarray(_x(2, 32, seed=32), jnp.bfloat16)
    # bf16 values cross exactly as float32
    tp, tx = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32))
        .to(torch.bfloat16), (jp, x))
    y, aux = jax_moe.apply(jp, x, jspec, jnp.bfloat16)
    ty, taux = moe.apply(tp, tx, tspec, torch.bfloat16)
    assert ty.dtype == torch.bfloat16
    _close(ty.float(), np.asarray(y, np.float32), BF16_TOL, "y")
    for name in aux:
        _close(taux[name], aux[name], BF16_TOL, name)


@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
def test_dispatch_indices_against_a_python_loop(cf):
    """`dispatch_indices` against a direct loop over each row's (token,
    choice) pairs in (expert, token, choice) order: the slot each pair
    gets, E·C when dropped, and the token each slot reads, N when empty."""
    e, k, n, b = 4, 2, 12, 3
    spec = moe.MoESpec(D, F, e, k, cf)
    cap = moe.capacity(n, spec)
    rng = np.random.default_rng(41)
    idx = np.stack([np.stack([rng.choice(e, k, replace=False)
                              for _ in range(n)]) for _ in range(b)])
    token_for_slot, slot_for_choice = moe.dispatch_indices(
        torch.from_numpy(idx), cap, e)
    assert token_for_slot.dtype == slot_for_choice.dtype == torch.int32
    for r in range(b):
        want_tok = np.full(e * cap, n)
        want_slot = np.full(n * k, e * cap)
        fill = [0] * e
        pairs = sorted(range(n * k), key=lambda i: (idx[r].reshape(-1)[i], i))
        for i in pairs:
            ex = idx[r].reshape(-1)[i]
            if fill[ex] < cap:
                want_slot[i] = ex * cap + fill[ex]
                want_tok[ex * cap + fill[ex]] = i // k
            fill[ex] += 1
        assert token_for_slot[r].tolist() == want_tok.tolist()
        assert slot_for_choice[r].tolist() == want_slot.tolist()
