"""Port `checkpoint/` against the JAX package's: one on-disk layout.

A state saved by `repro.checkpoint.save` restores into the port and a
state saved by the port restores into the reference, leaf for leaf and
bit for bit, bf16 leaves and the elastic agent remap (shrink and grow)
included; both write the same arrays and the same manifest. Retention,
`latest_step` and the async saver behave as in `tests/test_checkpoint.py`,
and a train state restored into the port continues the step with the same
numbers as the uninterrupted run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro_torch import checkpoint as ck
from repro_torch.configs import base
from repro_torch.launch import mesh, train
from repro_torch.tree import tree_leaves, tree_paths

from _torch_parity import TCFG


def _arrays(m, seed=0):
    """Numpy values of a small stacked state (float32 and bf16 leaves)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((m, 3, 5)).astype(np.float32),
        "h": rng.standard_normal((m, 6)).astype(np.float32),
        "b": rng.standard_normal((m, 4)).astype(np.float32),
    }


def _jax_state(m, seed=0):
    a = _arrays(m, seed)
    return {
        "params": {"w": jnp.asarray(a["w"]), "h": jnp.asarray(a["h"]).astype(jnp.bfloat16)},
        "opt": {"momentum": {"w": jnp.asarray(a["w"]) * 0.5,
                             "h": jnp.asarray(a["b"][:, :1].repeat(6, 1)).astype(jnp.bfloat16)}},
        "step": jnp.asarray(7, jnp.int32),
    }


def _to_port(jstate) -> dict:
    def leaf(x):
        x = np.asarray(jnp.asarray(x).astype(jnp.float32))
        return torch.from_numpy(x.copy())

    t = jax.tree.map(leaf, jstate)
    t["params"]["h"] = t["params"]["h"].to(torch.bfloat16)
    t["opt"]["momentum"]["h"] = t["opt"]["momentum"]["h"].to(torch.bfloat16)
    t["step"] = int(jstate["step"])
    # the port's dicts in its own (insertion) order, not JAX's sorted one
    return {"step": t["step"], "params": {"w": t["params"]["w"], "h": t["params"]["h"]},
            "opt": t["opt"]}


def _example(m) -> dict:
    """The port's example state: meta tensors and an int counter."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "params": {"h": meta((m, 6), torch.bfloat16), "w": meta((m, 3, 5), torch.float32)},
        "opt": {"momentum": {"h": meta((m, 6), torch.bfloat16),
                             "w": meta((m, 3, 5), torch.float32)}},
        "step": 0,
    }


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    x = np.asarray(x)
    if x.dtype == np.dtype("V2"):   # bf16 bits as the reference reads them
        return (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pairs(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = [ttree["opt"]["momentum"]["h"], ttree["opt"]["momentum"]["w"],
          ttree["params"]["h"], ttree["params"]["w"]]
    return list(zip(jl[:4], tl))


@pytest.mark.parametrize("m_new", [None, 4, 2, 7], ids=["same", "same_m", "shrink", "grow"])
def test_jax_save_restores_into_the_port(tmp_path, m_new):
    js = _jax_state(4)
    jck.save(str(tmp_path), 7, js)
    m = m_new or 4
    got, step = ck.restore(str(tmp_path), _example(m), num_agents=m_new, device="cpu")
    assert step == 7 and got["step"] == 7
    assert got["params"]["h"].dtype == torch.bfloat16
    want, _ = jck.restore(str(tmp_path), _jax_state(m), num_agents=m_new)
    for a, b in _pairs(want, got):
        assert b.shape[0] == m
        np.testing.assert_array_equal(_f32(b), _f32(a))
    if m == 7:                       # grown agents are clones of agent 0
        assert torch.equal(got["params"]["w"][5], got["params"]["w"][0])


@pytest.mark.parametrize("m_new", [None, 2, 7], ids=["same", "shrink", "grow"])
def test_port_save_restores_into_jax(tmp_path, m_new):
    ts = _to_port(_jax_state(4, seed=1))
    ck.save(str(tmp_path), 7, ts)
    m = m_new or 4
    got, step = jck.restore(str(tmp_path), _jax_state(m), num_agents=m_new)
    assert step == 7 and int(got["step"]) == 7
    assert np.asarray(got["step"]).dtype == np.int32
    for a, b in _pairs(got, ts):
        want = _f32(b)[:m] if m <= 4 else np.concatenate(
            [_f32(b), np.repeat(_f32(b)[:1], m - 4, axis=0)])
        np.testing.assert_array_equal(_f32(a), want)


def test_both_packages_write_the_same_files(tmp_path):
    js = _jax_state(4, seed=2)
    jpath = jck.save(str(tmp_path / "jax"), 3, js)
    tpath = ck.save(str(tmp_path / "port"), 3, _to_port(js))
    with open(os.path.join(jpath, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tpath, "manifest.json")) as f:
        tm = json.load(f)
    jm.pop("time"), tm.pop("time")
    assert tm == jm
    with np.load(os.path.join(jpath, "state.npz")) as a, \
            np.load(os.path.join(tpath, "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_a_bf16_leaf_needs_a_bf16_example(tmp_path):
    ck.save(str(tmp_path), 1, {"h": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        ck.restore(str(tmp_path), {"h": torch.empty(2)}, device="cpu")


def _port_state(m=4):
    return _to_port(_jax_state(m))


def test_save_restore_roundtrip(tmp_path):
    st = _port_state()
    ck.save(str(tmp_path), 5, st)
    got, step = ck.restore(str(tmp_path), st, device="cpu")
    assert step == 5
    for a, b in zip(tree_leaves(got), tree_leaves(st)):
        assert a == b if isinstance(b, int) else torch.equal(a, b)


def test_retention_keeps_latest_k(tmp_path):
    st = _port_state()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, st, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000004", "step_0000000005"]
    assert ck.latest_step(str(tmp_path)) == 5
    assert ck.latest_step(str(tmp_path / "missing")) is None


def test_async_checkpointer(tmp_path):
    st = _port_state()
    ac = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    ac.save(10, st)
    ac.save(20, st)
    ac.wait()
    assert ck.latest_step(str(tmp_path)) == 20
    got, _ = ck.restore(str(tmp_path), st, device="cpu")
    assert torch.equal(got["params"]["h"], st["params"]["h"])
    ac.close()


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    st = {"w": torch.zeros(3)}
    ac = ck.AsyncCheckpointer(str(tmp_path / "ok"))
    ac.save(1, st)
    st["w"].add_(1.0)                       # written after the snapshot
    ac.wait()
    got, _ = ck.restore(str(tmp_path / "ok"), st, device="cpu")
    assert not got["w"].any()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = ck.AsyncCheckpointer(str(blocker))
    bad.save(1, st)
    with pytest.raises(OSError):
        bad.wait()
    bad.close()


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path), _port_state(), device="cpu")


def test_restored_train_state_continues_the_run(tmp_path):
    """3 steps in one go, and 1 step → save → restore → 2 steps: the same
    losses and the same state, bit for bit."""
    tt = base.TrainConfig(agent_layout="data_dp", microbatch=2, gossip="auto",
                          learning_rate=0.05)
    w = np.zeros((4, 4))
    for i in range(4):
        w[i, i] = 0.5
        w[i, (i + 1) % 4] = w[(i + 1) % 4, i] = 0.25
    art = train.build_train_artifacts(
        TCFG, tt, base.ShapeConfig("s", 16, 8, "train"),
        mesh.make_test_mesh((4, 1)), w, device="cpu")
    assert art.gossip == "sparse"
    gen = torch.Generator().manual_seed(1)
    batches = [{"tokens": torch.randint(0, TCFG.vocab_size, (4, 2, 1, 17),
                                        generator=gen)} for _ in range(3)]
    straight = art.init_state(0)
    losses = []
    for b in batches:
        straight, met = art.step_fn(straight, b)
        losses.append(float(met["loss"]))

    state, met = art.step_fn(art.init_state(0), batches[0])
    resumed = [float(met["loss"])]
    ck.save(str(tmp_path), state["step"], state)
    state, step = ck.restore(str(tmp_path), art.state_shapes, device="cpu")
    assert step == state["step"] == 1
    for b in batches[1:]:
        state, met = art.step_fn(state, b)
        resumed.append(float(met["loss"]))
    assert resumed == losses
    assert state["step"] == straight["step"] == 3
    for a, b in zip(tree_leaves(state), tree_leaves(straight)):
        assert a == b if isinstance(b, int) else torch.equal(a, b)


def test_jax_train_state_restores_into_the_ports_shapes(tmp_path):
    """The reference's launcher state (agents stacked, sorted leaves, an
    int32 step) restores into ``TrainArtifacts.state_shapes``."""
    from repro import compat as jcompat
    from repro.configs import base as jbase
    from repro.launch import mesh as jmesh
    from repro.launch import train as jtrain
    from repro_torch.models import convert

    from _torch_parity import JCFG

    jm = jmesh.make_test_mesh((1, 1))
    with jcompat.set_mesh(jm):
        jart = jtrain.build_train_artifacts(
            JCFG, jbase.TrainConfig(), jbase.ShapeConfig("s", 16, 2, "train"),
            jm, None)
        jstate = jart.init_state(jax.random.key(0))
    jck.save(str(tmp_path), 0, jstate)
    art = train.build_train_artifacts(     # grown to 3 agents
        TCFG, base.TrainConfig(), base.ShapeConfig("s", 16, 6, "train"),
        mesh.make_test_mesh((3, 1)), None, device="cpu")
    got, _ = ck.restore(str(tmp_path), art.state_shapes, num_agents=3,
                        device="cpu")
    want = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x[0]), jstate["params"]), TCFG, "cpu")
    want = dict(tree_paths(want))
    for path, a in tree_paths(got["params"]):
        assert a.shape[0] == 3
        for agent in range(3):
            assert torch.equal(a[agent], want[path]), path
    assert got["step"] == 0
