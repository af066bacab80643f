"""Port `launch/train.py` against the JAX package's launcher step.

The same initial state (the reference's `init_state`, agent 0 converted
with `models.convert` and replicated: its agents start identical) and the
same tokens go through both. Limits are those of `test_torch_dpsgd.py`:
losses to rtol 1e-4 and the parameters to atol 1e-4 after 3 steps (float32
sums in another order; the sparse mix adds the neighbours in ascending
order, the reference's schedule in round order); the momentum too, plus
one bf16 ulp of the gradients under `data_dp` (`_assert_momentum`).

* m = 1 runs in this process on a (1, 1) mesh: no gossip, two
  microbatches, remat on and off, the `data` and `data_dp` layouts, a
  `cosine` schedule.
* m = 4 needs four JAX devices, so the reference runs in one subprocess
  that forces them before importing jax (as `test_multidevice.py` does),
  steps every gossip mode on a (4, 1) mesh and writes losses and states
  to an `npz` (about a minute on the CPU). On the CPU the port's `sparse`
  mode takes the kernel's plain version, one call per leaf per step. The
  same comparison refuses the port with its mix replaced by the identity
  or with a neighbour dropped, so the limits can tell a missing mix.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import compat as jcompat
from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.optim import schedule as jschedule
from repro_torch.configs import base
from repro_torch.core import dpsgd, gossip
from repro_torch.data import DataConfig, SyntheticTokenStream, make_batch_fn
from repro_torch.kernels import ops
from repro_torch.launch import mesh, train
from repro_torch.models import convert
from repro_torch.optim import schedule, sgd
from repro_torch.tree import tree_leaves, tree_paths

from _torch_parity import JCFG, TCFG

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3
LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4


def _nest(flat: dict) -> dict:
    """``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _port_state(agent0: dict, m: int) -> dict:
    params = dpsgd.replicate_for_agents(
        convert.params_from_jax(agent0, TCFG, "cpu"), m)
    return {"params": params, "opt": sgd.init(params), "step": 0}


def _max_diff(want: dict, got_tree) -> float:
    got = dict(tree_paths(convert.params_to_jax(got_tree)))
    assert want.keys() == got.keys()
    return max(float(np.abs(want[k] - got[k]).max()) for k in want)


def _assert_momentum(want: dict, got_tree, layout: str) -> None:
    """Under ``data_dp`` the momentum sums gradients rounded to bf16, and
    a float32 difference far below 1e-4 can round a gradient to the
    neighbouring bf16 value: one bf16 ulp (2^-7 relative) of the leaf's
    largest gradient more. The parameters see it times lr, under 1e-4."""
    got = dict(tree_paths(convert.params_to_jax(got_tree)))
    assert want.keys() == got.keys()
    for k in want:
        limit = STATE_ATOL
        if layout == "data_dp":
            limit += 2.0**-7 * float(np.abs(want[k]).max())
        assert float(np.abs(want[k] - got[k]).max()) <= limit, k


def _tcfgs(**kw):
    return jbase.TrainConfig(**kw), base.TrainConfig(**kw)


# ---------------------------------------------------------------------------
# m = 1, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["data", "data_dp"])
@pytest.mark.parametrize("remat", ["full", "none"])
def test_one_agent_matches_jax(layout, remat):
    jt, tt = _tcfgs(agent_layout=layout, remat=remat, gossip="none",
                    microbatch=2, learning_rate=0.05)
    jshape = jbase.ShapeConfig("one_agent", 16, 2, "train")
    tshape = base.ShapeConfig("one_agent", 16, 2, "train")
    jm = jmesh.make_test_mesh((1, 1))
    with jcompat.set_mesh(jm):
        jart = jtrain.build_train_artifacts(
            JCFG, jt, jshape, jm, None,
            learning_rate=jschedule.cosine(0.05, 6, warmup=1))
        jstate = jart.init_state(jax.random.key(0))
        jstep = jart.jit(donate=False)
    art = train.build_train_artifacts(
        TCFG, tt, tshape, mesh.make_test_mesh((1, 1)), None,
        learning_rate=schedule.cosine(0.05, 6, warmup=1), device="cpu")
    assert art.gossip == "none" and art.num_agents == 1
    agent0 = jax.tree.map(lambda x: np.asarray(x[0]), jstate["params"])
    state = _port_state(agent0, 1)
    data = SyntheticTokenStream(DataConfig(
        vocab_size=TCFG.vocab_size, seq_len=16, num_agents=1, seed=1))
    batch_fn = make_batch_fn(data, art.batch_shapes, TCFG.vocab_size)
    jl, tl, lrs = [], [], []
    for k in range(STEPS):
        batch = batch_fn(k)
        with jcompat.set_mesh(jm):
            jstate, jmet = jstep(jstate, batch)
        state, met = art.step_fn(state, batch)
        jl.append(float(jmet["loss"]))
        tl.append(float(met["loss"]))
        lrs.append((met["lr"], float(jmet["lr"])))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for got, want in lrs:
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert state["step"] == int(jstate["step"]) == STEPS
    want = dict(tree_paths(jax.tree.map(np.asarray, jstate["params"])))
    assert _max_diff(want, state["params"]) <= STATE_ATOL
    want_m = dict(tree_paths(
        jax.tree.map(np.asarray, jstate["opt"]["momentum"])))
    _assert_momentum(want_m, state["opt"]["momentum"], layout)


# ---------------------------------------------------------------------------
# m = 4, the reference in a subprocess
# ---------------------------------------------------------------------------

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, numpy as np
from repro import compat
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs.qwen2_0_5b import SMOKE_CONFIG as cfg
from repro.data.pipeline import make_batch_fn
from repro.data.synthetic import DataConfig, SyntheticTokenStream
from repro.launch.fabric import design_mixing_matrix
from repro.launch.mesh import make_test_mesh
from repro.launch.train import build_train_artifacts

out_path, steps = sys.argv[1], int(sys.argv[2])
m = 4
shape = ShapeConfig("train_parity", 16, 8, "train")
mesh = make_test_mesh((m, 1))
w_design = np.asarray(design_mixing_matrix(m, 1, 1e6, iterations=4)[0])
modes = {
    "auto": ("data", "auto", w_design),
    "dense": ("data", "dense", w_design),
    "allreduce": ("data", "auto", np.full((m, m), 1.0 / m)),
    "sparse_data_dp": ("data_dp", "sparse", w_design),
}

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in paths(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, np.asarray(tree))]

stream = SyntheticTokenStream(DataConfig(
    vocab_size=cfg.vocab_size, seq_len=16, num_agents=m, seed=1))
out = {}
for name, (layout, gossip, w) in modes.items():
    tcfg = TrainConfig(agent_layout=layout, gossip=gossip, microbatch=2,
                       learning_rate=0.05)
    with compat.set_mesh(mesh):
        art = build_train_artifacts(cfg, tcfg, shape, mesh, w)
        if name == "auto":
            out["auto_ppermute"] = np.asarray(
                "collective_permute" in art.lower().as_text())
        step = art.jit(donate=False)
        state = art.init_state(jax.random.key(0))
        if name == "auto":
            for p, a in paths(state["params"]):
                out[f"init/{p}"] = a[0]
        batch_fn = make_batch_fn(stream, art.batch_shapes, cfg.vocab_size)
        losses = []
        for k in range(steps):
            batch = batch_fn(k)
            out[f"tokens/{k}"] = batch["tokens"]
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
    out[f"{name}/w"] = w
    out[f"{name}/losses"] = np.asarray(losses)
    for p, a in paths(state["params"]):
        out[f"{name}/params/{p}"] = a
    for p, a in paths(state["opt"]["momentum"]):
        out[f"{name}/momentum/{p}"] = a
np.savez(out_path, **out)
print("JAX_M4_OK")
"""

# mode -> (layout, gossip asked, mode the port must resolve)
M4_MODES = {
    "auto": ("data", "auto", "sparse"),
    "dense": ("data", "dense", "dense"),
    "allreduce": ("data", "auto", "allreduce"),
    "sparse_data_dp": ("data_dp", "sparse", "sparse"),
}


@pytest.fixture(scope="module")
def jax_m4(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_m4") / "reference.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(path), str(STEPS)],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT), env=env,
    )
    assert "JAX_M4_OK" in res.stdout, (res.stdout + res.stderr)[-4000:]
    with np.load(path) as data:
        return dict(data)


def _section(ref: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _spy_combine(monkeypatch) -> list:
    """Record ``(g, lr)`` of every call of the stacked kernel's entry."""
    calls = []
    real = ops.mixing_sgd_combine_stacked

    def spy(x, idx, weights, g=None, *, lr=None):
        calls.append((g, lr))
        return real(x, idx, weights, g, lr=lr)

    monkeypatch.setattr(ops, "mixing_sgd_combine_stacked", spy)
    return calls


def _port_m4(jax_m4: dict, name: str):
    """The port's ``STEPS`` steps in mode ``name`` from the reference's
    initial state on its tokens: ``(art, state, losses)``."""
    layout, gossip_mode, _ = M4_MODES[name]
    tt = base.TrainConfig(agent_layout=layout, gossip=gossip_mode,
                          microbatch=2, learning_rate=0.05)
    art = train.build_train_artifacts(
        TCFG, tt, base.ShapeConfig("train_parity", 16, 8, "train"),
        mesh.make_test_mesh((4, 1)), jax_m4[f"{name}/w"], device="cpu")
    state = _port_state(_nest(_section(jax_m4, "init/")), 4)
    losses = []
    for k in range(STEPS):
        state, met = art.step_fn(state, {"tokens": jax_m4[f"tokens/{k}"]})
        losses.append(float(met["loss"]))
    return art, state, losses


@pytest.mark.parametrize("name", list(M4_MODES))
def test_four_agents_match_jax(jax_m4, name, monkeypatch):
    layout, _, resolved = M4_MODES[name]
    if name == "auto":
        assert bool(jax_m4["auto_ppermute"])    # the reference went sparse
    calls = _spy_combine(monkeypatch)
    ops.reset_launch_count()
    art, state, losses = _port_m4(jax_m4, name)
    assert art.gossip == resolved
    leaves = len(tree_leaves(state["params"]))
    # one call of the kernel's entry point per leaf per step, its g=None
    # form; on the CPU each goes to the plain version and launches nothing
    assert len(calls) == (STEPS * leaves if resolved == "sparse" else 0)
    assert all(c == (None, None) for c in calls)
    assert ops.launch_count("mixing_sgd_combine") == 0
    np.testing.assert_allclose(losses, jax_m4[f"{name}/losses"],
                               rtol=LOSS_RTOL)
    assert _max_diff(_section(jax_m4, f"{name}/params/"),
                     state["params"]) <= STATE_ATOL
    _assert_momentum(_section(jax_m4, f"{name}/momentum/"),
                     state["opt"]["momentum"], layout)


def _drop_first_neighbour(real):
    """``mix_sparse`` with each agent's first neighbour left out (the
    table pads short rows at their end, so that column is a real one)."""
    def mix(params, idx, weights):
        dropped = weights.clone()
        dropped[:, 1] = 0.0
        return real(params, idx, dropped)
    return mix


M4_FAULTS = [(name, "identity") for name in M4_MODES] + [
    (name, "dropped_neighbour")
    for name, (_, _, resolved) in M4_MODES.items() if resolved == "sparse"
]


@pytest.mark.parametrize("name,fault", M4_FAULTS)
def test_four_agents_faulty_mix_is_refused(jax_m4, name, fault, monkeypatch):
    """The parity above must be able to fail: with the mix replaced by the
    identity, or with a neighbour dropped, the port's parameters after
    ``STEPS`` steps lie beyond ``STATE_ATOL`` of the reference's."""
    if fault == "identity":
        for mix in ("mix_sparse", "mix_dense"):
            monkeypatch.setattr(gossip, mix, lambda params, *_: params)
        monkeypatch.setattr(gossip, "mix_allreduce", lambda params: params)
    else:
        monkeypatch.setattr(gossip, "mix_sparse",
                            _drop_first_neighbour(gossip.mix_sparse))
    _, state, _ = _port_m4(jax_m4, name)
    assert _max_diff(_section(jax_m4, f"{name}/params/"),
                     state["params"]) > STATE_ATOL


# ---------------------------------------------------------------------------
# Shapes, modes and the pieces of the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "agents,batch,microbatch", [(4, 8, 2), (4, 12, 2), (2, 8, 0), (1, 3, 3)],
)
def test_shapes_match_jax(agents, batch, microbatch):
    """``[A, k, mb, S+1]`` with the reference's fall-back to k = 1, and the
    stacked state's shapes and dtypes leaf for leaf."""
    jshape = jbase.ShapeConfig("s", 32, batch, "train")
    want = jtrain._batch_shapes(JCFG, jshape, agents, microbatch)["tokens"]
    got = train._batch_shapes(TCFG, base.ShapeConfig("s", 32, batch, "train"),
                              agents, microbatch)["tokens"]
    assert tuple(got.shape) == want.shape and got.dtype == torch.int32
    jstate = jtrain._stacked_state_shapes(JCFG, agents)
    tstate = train._stacked_state_shapes(TCFG, agents)
    for part in ("params", "opt"):
        w = dict(tree_paths(jax.tree.map(
            lambda s: f"{tuple(s.shape)} {s.dtype}", jstate[part])))
        g = {k: f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')}"
             for k, t in tree_paths(tstate[part])}
        assert g == w
    assert tstate["step"] == 0


def _ring4():
    w = np.zeros((4, 4))
    for i in range(4):
        w[i, i] = 0.5
        w[i, (i + 1) % 4] = w[(i + 1) % 4, i] = 0.25
    return w


@pytest.mark.parametrize(
    "gossip,w,want",
    [("auto", "ring", "sparse"), ("auto", "clique", "dense"),
     ("auto", "j", "allreduce"), ("sparse", "j", "sparse"),
     ("dense", "ring", "dense"), ("allreduce", "ring", "allreduce"),
     ("none", "ring", "none"), ("auto", None, "none")],
)
def test_gossip_resolution_matches_reference(gossip, w, want):
    mats = {"ring": _ring4(), "j": np.full((4, 4), 0.25),
            "clique": 0.5 * np.eye(4) + np.full((4, 4), 0.5 / 4)}
    mode, w_arr = train.resolve_gossip(gossip, mats.get(w), 4)
    assert mode == want
    assert (w_arr is None) == (w is None)


def test_build_refuses_what_the_reference_refuses():
    tt = base.TrainConfig(gossip="auto")
    shape = base.ShapeConfig("s", 16, 8, "train")
    with pytest.raises(ValueError, match="layout implies m=4"):
        train.build_train_artifacts(TCFG, tt, shape, mesh.make_test_mesh((4, 1)),
                                    np.eye(3), device="cpu")
    with pytest.raises(ValueError, match="gossip mode"):
        train.build_train_artifacts(
            TCFG, dataclasses.replace(tt, gossip="ring"), shape,
            mesh.make_test_mesh((4, 1)), _ring4(), device="cpu")


def test_init_state_and_the_step_pieces(monkeypatch):
    tt = base.TrainConfig(agent_layout="data_dp", microbatch=2, gossip="auto")
    art = train.build_train_artifacts(
        TCFG, tt, base.ShapeConfig("s", 16, 8, "train"),
        mesh.make_test_mesh((4, 1)), _ring4(), device="cpu")
    state = art.init_state(3)
    assert state["step"] == 0
    for p, mom in zip(tree_leaves(state["params"]),
                      tree_leaves(state["opt"]["momentum"])):
        assert p.shape[0] == 4 and torch.equal(p[0], p[3])
        assert mom.dtype == p.dtype and not mom.any()
    tokens = torch.randint(0, TCFG.vocab_size, (4, 2, 1, 17),
                           generator=torch.Generator().manual_seed(0))
    grad_dtypes = []
    real_update = sgd.update

    def update(grads, *args, **kw):
        grad_dtypes.extend(g.dtype for g in tree_leaves(grads))
        return real_update(grads, *args, **kw)

    monkeypatch.setattr(sgd, "update", update)
    calls = _spy_combine(monkeypatch)
    new_state, met = art.step_fn(state, {"tokens": tokens.numpy()})
    leaves = len(tree_leaves(state["params"]))
    # data_dp hands the update bf16 gradients, accumulated in fp32
    assert grad_dtypes == [torch.bfloat16] * leaves
    # the ring resolves to the sparse gossip: one g=None call per leaf
    assert art.gossip == "sparse" and calls == [(None, None)] * leaves
    assert met["loss"].shape == () and bool(torch.isfinite(met["loss"]))
    assert new_state["step"] == 1 and met["lr"] == float(np.float32(0.01))
    assert state["step"] == 0                   # the input is not written
