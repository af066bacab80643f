"""Port kernels, CPU side: the plain PyTorch versions (which the wrappers
take for CPU tensors) against the JAX package's oracle, against its Pallas
kernel in interpret mode, and against the unfused D-PSGD update.

The CUDA kernel itself runs only on a GPU; `chip_smoke.py` holds it against
these same plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dpsgd as jax_dpsgd
from repro.kernels import ref as jax_ref
from repro.kernels.mixing_combine import mixing_sgd_combine as pallas_combine
from repro_torch.core import gossip, mixing
from repro_torch.kernels import ops, ref

FP32_TOL = 1e-5  # rtol = atol, the JAX package's own for this kernel
BF16_TOL = 2e-2  # rtol = atol, the JAX package's bf16 kernel tolerance


def _inputs(seed, n, r):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal(n).astype(np.float32),
        rng.standard_normal((r, n)).astype(np.float32),
        rng.uniform(size=r + 1).astype(np.float32),
        rng.standard_normal(n).astype(np.float32),
    )


CASES = [(1 << 16, 3, 16384), (1 << 14, 1, 1 << 14), (1 << 15, 6, 4096)]


@pytest.mark.parametrize("n,r,block", CASES)
def test_plain_matches_jax_oracle(n, r, block):
    x, recv, w, mom = _inputs(n + r, n, r)
    got = ops.mixing_sgd_combine(
        *(torch.from_numpy(a) for a in (x, recv, w, mom)), lr=0.1
    )
    exp = jax_ref.mixing_sgd_combine_ref(
        *(jnp.asarray(a) for a in (x, recv, w, mom)), lr=0.1
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(exp), rtol=FP32_TOL, atol=FP32_TOL
    )


@pytest.mark.parametrize("n,r,block", CASES)
def test_plain_matches_pallas_interpret(n, r, block):
    x, recv, w, mom = _inputs(n + r + 1, n, r)
    got = ops.mixing_sgd_combine(
        *(torch.from_numpy(a) for a in (x, recv, w, mom)), lr=0.1
    )
    exp = pallas_combine(
        *(jnp.asarray(a) for a in (x, recv, w, mom)),
        lr=0.1, block_n=block, interpret=True,
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(exp), rtol=FP32_TOL, atol=FP32_TOL
    )


@pytest.mark.parametrize("n,r", [(65537, 3), (1001, 2), (1 << 12, 0), (7, 0)])
def test_plain_ragged_n_and_no_neighbours(n, r):
    """Any N and R = 0 are accepted (the TPU kernel raises on ragged N)."""
    x, recv, w, mom = _inputs(n, n, r)
    got = ops.mixing_sgd_combine(
        *(torch.from_numpy(a) for a in (x, recv, w, mom)), lr=0.1
    )
    exp = jax_ref.mixing_sgd_combine_ref(
        *(jnp.asarray(a) for a in (x, recv, w, mom)), lr=0.1
    )
    assert got.shape == (n,)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(exp), rtol=FP32_TOL, atol=FP32_TOL
    )


@pytest.mark.parametrize("mom_dtype", ["float32", "bfloat16"])
def test_plain_bf16(mom_dtype):
    """bf16 x with fp32 or bf16 momentum: fp32 accumulate, one rounding."""
    x, recv, w, mom = _inputs(5, 1 << 12, 3)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[mom_dtype]
    got = ops.mixing_sgd_combine(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(recv).to(torch.bfloat16),
        torch.from_numpy(w),
        torch.from_numpy(mom).to(tdt),
        lr=0.1,
    )
    exp = jax_ref.mixing_sgd_combine_ref(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(recv).astype(jnp.bfloat16),
        jnp.asarray(w),
        jnp.asarray(mom).astype(jnp.dtype(mom_dtype)),
        lr=0.1,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(exp, np.float32),
        rtol=BF16_TOL, atol=BF16_TOL,
    )


def _ring(m):
    links = [(i, (i + 1) % m) for i in range(m)]
    return mixing.matrix_from_weights(m, links, [1.0 / 3.0] * m)


def _asym_support(m):
    """Symmetric values are not needed by the kernel: rows of different
    in-degree exercise the padding slots."""
    rng = np.random.default_rng(3)
    w = np.zeros((m, m))
    for a in range(m):
        for j in rng.choice(m, size=a % 3 + 1, replace=False):
            w[a, j] = rng.uniform(0.1, 0.4)
        w[a, a] = 1.0 - w[a].sum() + w[a, a]
    return w


@pytest.mark.parametrize(
    "name,w",
    [
        ("ring8", _ring(8)),
        ("clique5", mixing.ideal_matrix(5)),
        ("asym6", _asym_support(6)),
        ("identity4", np.eye(4)),
    ],
)
def test_stacked_plain_matches_unfused_jax_update(name, w):
    """Stacked plain version == `mix_params` followed by `p − η g`."""
    m = w.shape[0]
    rng = np.random.default_rng(11)
    p = rng.standard_normal((m, 3, 37)).astype(np.float32)
    g = rng.standard_normal((m, 3, 37)).astype(np.float32)
    eta = 0.05
    mixed = jax_dpsgd.mix_params({"p": jnp.asarray(p)}, jnp.asarray(w))["p"]
    exp = np.asarray(mixed - jnp.asarray(eta, jnp.float32) * jnp.asarray(g))
    idx, wt = gossip.neighbor_table(w)
    got = ops.mixing_sgd_combine_stacked(
        torch.from_numpy(p).reshape(m, -1), torch.from_numpy(idx),
        torch.from_numpy(wt), torch.from_numpy(g).reshape(m, -1), lr=eta,
    ).reshape(p.shape)
    np.testing.assert_allclose(
        got.numpy(), exp, rtol=FP32_TOL, atol=FP32_TOL
    )


def test_stacked_agrees_with_per_agent_entry():
    """One device function, two entry points: row a of the stacked form is
    the per-agent form fed with the neighbours' rows."""
    w = _ring(6)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 515)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 515)).astype(np.float32))
    idx_np, wt_np = gossip.neighbor_table(w)
    idx, wt = torch.from_numpy(idx_np), torch.from_numpy(wt_np)
    stacked = ref.mixing_sgd_combine_stacked_ref(x, idx, wt, g, lr=0.1)
    assert stacked.data_ptr() != x.data_ptr()
    for a in range(6):
        one = ref.mixing_sgd_combine_ref(
            x[a], x[idx[a].long()], wt[a], g[a], lr=0.1
        )
        np.testing.assert_allclose(
            stacked[a].numpy(), one.numpy(), rtol=FP32_TOL, atol=FP32_TOL
        )


@pytest.mark.parametrize(
    "case",
    ["lr_tensor", "idx_int64", "weights_shape", "x_dtype", "g_dtype",
     "noncontiguous", "idx_range", "recv_shape"],
)
def test_wrappers_reject_bad_operands(case):
    x = torch.zeros(4, 8)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    wt = torch.zeros(4, 3)
    g = torch.zeros(4, 8)
    stacked = ops.mixing_sgd_combine_stacked
    with pytest.raises((TypeError, ValueError)):
        if case == "lr_tensor":
            stacked(x, idx, wt, g, lr=torch.tensor(0.1))
        elif case == "idx_int64":
            stacked(x, idx.long(), wt, g, lr=0.1)
        elif case == "weights_shape":
            stacked(x, idx, wt[:, :2].contiguous(), g, lr=0.1)
        elif case == "x_dtype":
            stacked(x.double(), idx, wt, g.double(), lr=0.1)
        elif case == "g_dtype":
            stacked(x, idx, wt, g.to(torch.bfloat16), lr=0.1)
        elif case == "noncontiguous":
            stacked(torch.zeros(8, 4).T, idx, wt, g, lr=0.1)
        elif case == "idx_range":
            stacked(x, idx + 4, wt, g, lr=0.1)
        elif case == "recv_shape":
            ops.mixing_sgd_combine(
                x[0], torch.zeros(2, 7), wt[0], g[0], lr=0.1
            )


MIX_CASES = [
    ("ring8", _ring(8)), ("clique5", mixing.ideal_matrix(5)),
    ("asym6", _asym_support(6)), ("identity4", np.eye(4)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,w", MIX_CASES)
def test_stacked_plain_without_g_is_the_g_form_at_zero(name, w, dtype):
    """The mix alone (``g=None``, the launcher's sparse gossip) is bitwise
    the fused form with ``g = 0``, and holds against the reference's
    ``mix_dense`` (float32)."""
    m = w.shape[0]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((m, 259)).astype(np.float32))
    x = x.to(dtype)
    idx_np, wt_np = gossip.neighbor_table(w)
    idx, wt = torch.from_numpy(idx_np), torch.from_numpy(wt_np)
    got = ops.mixing_sgd_combine_stacked(x, idx, wt)
    zero = ref.mixing_sgd_combine_stacked_ref(
        x, idx, wt, torch.zeros_like(x), lr=0.05)
    assert got.dtype == dtype
    assert torch.equal(got, zero)
    assert torch.equal(got, ref.mixing_sgd_combine_stacked_ref(x, idx, wt))
    if dtype == torch.float32:
        want = jax_dpsgd.mix_params({"p": jnp.asarray(x.numpy())},
                                    jnp.asarray(w))["p"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("case", ["g_without_lr", "lr_without_g"])
def test_stacked_lr_goes_with_g(case):
    x = torch.zeros(4, 8)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    wt = torch.zeros(4, 3)
    with pytest.raises(TypeError, match="lr scales g"):
        if case == "g_without_lr":
            ops.mixing_sgd_combine_stacked(x, idx, wt, torch.zeros(4, 8))
        else:
            ops.mixing_sgd_combine_stacked(x, idx, wt, lr=0.1)


def test_mix_sparse_is_one_g_free_call_per_leaf(monkeypatch):
    """``gossip.mix_sparse`` reaches the kernel's entry once per leaf,
    without a gradient, and agrees with ``mix_dense``."""
    w = _ring(5)
    rng = np.random.default_rng(4)
    params = {
        "a": torch.from_numpy(rng.standard_normal((5, 3, 7)).astype(np.float32)),
        "b": {"c": torch.from_numpy(rng.standard_normal((5, 11)).astype(np.float32))},
    }
    idx_np, wt_np = gossip.neighbor_table(w)
    calls = []
    real = ops.mixing_sgd_combine_stacked

    def spy(x, idx, weights, g=None, *, lr=None):
        calls.append((tuple(x.shape), g, lr))
        return real(x, idx, weights, g, lr=lr)

    monkeypatch.setattr(ops, "mixing_sgd_combine_stacked", spy)
    got = gossip.mix_sparse(params, torch.from_numpy(idx_np),
                            torch.from_numpy(wt_np))
    assert calls == [((5, 21), None, None), ((5, 11), None, None)]
    want = gossip.mix_dense(params, torch.from_numpy(w))
    torch.testing.assert_close(got["a"], want["a"], rtol=FP32_TOL, atol=FP32_TOL)
    torch.testing.assert_close(got["b"]["c"], want["b"]["c"], rtol=FP32_TOL,
                               atol=FP32_TOL)


PER_AGENT_MIX_CASES = [(1 << 16, 3), (1 << 14, 1), (65537, 6), (1001, 0)]


@pytest.mark.parametrize("n,r", PER_AGENT_MIX_CASES)
def test_per_agent_plain_without_momentum_is_the_mix(n, r):
    """``momentum=None`` (the gossip across ranks' combine) is bitwise the
    fused form with zero momentum, and holds against the JAX package's
    oracle and its Pallas kernel in interpret mode at ``lr = 0``."""
    x, recv, w, _ = _inputs(n + 7 * r, n, r)
    zeros = np.zeros_like(x)
    got = ops.mixing_sgd_combine(*(torch.from_numpy(a) for a in (x, recv, w)))
    fused = ref.mixing_sgd_combine_ref(
        *(torch.from_numpy(a) for a in (x, recv, w, zeros)), lr=0.1)
    assert torch.equal(got, fused)
    args = [jnp.asarray(a) for a in (x, recv, w, zeros)]
    exp = jax_ref.mixing_sgd_combine_ref(*args, lr=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=FP32_TOL, atol=FP32_TOL)
    if n % 1024 == 0:
        exp = pallas_combine(*args, lr=0.0, block_n=1024, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   rtol=FP32_TOL, atol=FP32_TOL)


def test_per_agent_bf16_without_momentum():
    x, recv, w, _ = _inputs(9, 1 << 12, 3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    rb = torch.from_numpy(recv).to(torch.bfloat16)
    got = ops.mixing_sgd_combine(xb, rb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    exp = jax_ref.mixing_sgd_combine_ref(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(recv).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.zeros(x.shape, jnp.bfloat16), lr=0.0)
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(exp).astype(np.float32),
        rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("case", ["momentum_without_lr", "lr_without_momentum"])
def test_per_agent_lr_goes_with_momentum(case):
    x, recv, w = torch.zeros(8), torch.zeros(2, 8), torch.zeros(3)
    with pytest.raises(TypeError, match="lr scales momentum"):
        if case == "momentum_without_lr":
            ops.mixing_sgd_combine(x, recv, w, torch.zeros(8))
        else:
            ops.mixing_sgd_combine(x, recv, w, lr=0.1)
