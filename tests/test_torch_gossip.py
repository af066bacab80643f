"""Port `core/gossip.py` + `core/mixing.py` against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jax_gossip
from repro.core import mixing as jax_mixing
from repro_torch.core import gossip, mixing


def _ring(m, alpha=1.0 / 3.0):
    links = [(i, (i + 1) % m) for i in range(m)]
    return mixing.matrix_from_weights(m, links, [alpha] * m)


def _random_sparse(m, seed):
    rng = np.random.default_rng(seed)
    links = [
        (i, j) for i in range(m) for j in range(i + 1, m)
        if rng.uniform() < 0.4
    ]
    alpha = rng.uniform(0.05, 0.2, size=len(links))
    return mixing.matrix_from_weights(m, links, alpha)


def _asym(m, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.05, 0.3, size=(m, m)) * (rng.uniform(size=(m, m)) < 0.35)
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


MATRICES = {
    "ring8": _ring(8),
    "clique6": mixing.ideal_matrix(6),
    "sparse10": _random_sparse(10, 0),
    "asym7": _asym(7, 1),
    "identity3": np.eye(3),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_build_schedule_equal_field_for_field(name):
    w = MATRICES[name]
    ours = dataclasses.asdict(gossip.build_schedule(w))
    theirs = dataclasses.asdict(jax_gossip.build_schedule(w))
    assert ours == theirs


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_neighbor_table_reproduces_w_at_x(name):
    """Σ over the table == W @ x (fp32 table vs fp64 product: 1e-6)."""
    w = MATRICES[name]
    m = w.shape[0]
    idx, wt = gossip.neighbor_table(w)
    degree = max(int((np.abs(w[a]) > 1e-12).sum() - (abs(w[a, a]) > 1e-12))
                 for a in range(m))
    assert idx.dtype == np.int32 and wt.dtype == np.float32
    assert idx.shape == (m, degree) and wt.shape == (m, degree + 1)
    assert ((idx >= 0) & (idx < m)).all()
    # padding slots: own row, weight exactly 0
    for a in range(m):
        for r in range(degree):
            if wt[a, r + 1] == 0.0:
                assert idx[a, r] == a
    x = np.random.default_rng(4).standard_normal((m, 33))
    got = wt[:, 0:1].astype(np.float64) * x
    for r in range(degree):
        got += wt[:, r + 1 : r + 2].astype(np.float64) * x[idx[:, r]]
    np.testing.assert_allclose(got, w @ x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ring8", "sparse10", "asym7"])
def test_mix_dense_matches_jax(name):
    w = MATRICES[name]
    m = w.shape[0]
    p = np.random.default_rng(5).standard_normal((m, 4, 9)).astype(np.float32)
    exp = jax_gossip.mix_dense({"p": jnp.asarray(p)}, jnp.asarray(w))["p"]
    got = gossip.mix_dense(
        {"p": torch.from_numpy(p)}, torch.from_numpy(w.astype(np.float32))
    )["p"]
    # fp32 sums of at most 10 terms in two orders
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)


def test_mix_allreduce_matches_jax():
    p = np.random.default_rng(6).standard_normal((5, 7)).astype(np.float32)
    exp = jax_gossip.mix_allreduce({"p": jnp.asarray(p)})["p"]
    got = gossip.mix_allreduce({"p": torch.from_numpy(p)})["p"]
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_effective_matrix_and_bytes_equal(rounds):
    w = MATRICES["sparse10"]
    assert np.array_equal(
        gossip.effective_mixing_matrix(w, rounds),
        jax_gossip.effective_mixing_matrix(w, rounds),
    )
    ours = gossip.gossip_collective_bytes(gossip.build_schedule(w), 1e6, rounds)
    theirs = jax_gossip.gossip_collective_bytes(
        jax_gossip.build_schedule(w), 1e6, rounds
    )
    assert ours == theirs
    with pytest.raises(ValueError):
        gossip.effective_mixing_matrix(w, 0)


@pytest.mark.parametrize("name", ["ring8", "sparse10", "clique6"])
def test_mixing_helpers_equal(name):
    """The port's own copy of the mixing algebra is bitwise the original."""
    w = MATRICES[name]
    m = w.shape[0]
    links, alpha = mixing.weights_from_matrix(w)
    jl, ja = jax_mixing.weights_from_matrix(w)
    assert links == jl and np.array_equal(alpha, ja)
    assert np.array_equal(
        mixing.matrix_from_weights(m, links, alpha),
        jax_mixing.matrix_from_weights(m, links, alpha),
    )
    assert mixing.rho(w) == jax_mixing.rho(w)
    assert np.array_equal(mixing.ideal_matrix(m), jax_mixing.ideal_matrix(m))
    mixing.validate_mixing(w)
    with pytest.raises(ValueError):
        mixing.validate_mixing(MATRICES["asym7"])
