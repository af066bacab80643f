"""A microbatch whose rows do not divide the batch role's ranks, split over
the largest group of ranks its rows divide (`launch/train.RowSplit`), in
gloo processes on the CPU, against the JAX package's 8-device GSPMD runs
on the same meshes (where the reference's spec drops the split and every
rank runs the whole microbatch).

The test writes one `npz` of inputs (the reference's initial parameters
of the smoke Mixtral and Qwen2, tokens, a 2-agent W), runs the reference
in one subprocess that forces 8 host devices before importing jax, and
beside it the port's ranks (`tests/_torch_rank.py`, one process a rank,
one `file://` rendezvous a case):

* `split_pod`: 3 launcher steps of the `pod` layout at (pod 2, data 4,
  model 1) — smoke Mixtral, E = 4 over 4 data ranks, microbatches of 2
  rows (g = gcd(2, 4) = 2: one row a rank, each row on 2 ranks), the
  load-balance loss at weight 1;
* `split_data_dp`: 3 steps of `data_dp` at (data 2, model 4) — smoke
  Qwen2, microbatches of 2 rows over 4 `model` ranks (g = 2).

Limits: `tests/test_torch_multirank.py`'s — losses rtol 1e-4, parameters
and momentum atol 1e-4 after 3 steps, plus one bf16 ulp of the gradients
in momentum under `data_dp`. Two faulty controls put in by the rank
script must be refused by the same comparisons: each rank's loss weighted
1/g in place of 1/n, and every group of ranks handed the same rows.

Besides, the rule alone (`RowSplit`, `local_batch`) on host meshes: each
row of a microbatch held by exactly n / g ranks for every (mb, n), g = n
the reference's split and g = 1 the whole microbatch on every rank.
"""

import math
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import mixtral_8x7b as jmixtral
from repro.configs import qwen2_0_5b as jqwen2
from repro.data.pipeline import make_batch_fn
from repro.data.synthetic import DataConfig, SyntheticTokenStream
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, train
from repro_torch.tree import tree_paths

import _torch_rank as rank_script
from test_torch_multirank import ROOT, TIMEOUT, _section, _x64_off

LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4

JCFGS = {"mixtral": jmixtral.SMOKE_CONFIG, "qwen2": jqwen2.SMOKE_CONFIG}
FAULTS = ("weight_over_groups", "same_rows")
CASES = tuple(rank_script.SPLIT_RUNS)
WORLD = 8

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, numpy as np
from repro import compat
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs import mixtral_8x7b, qwen2_0_5b
from repro.launch.train import build_train_artifacts

CFGS = {"mixtral": mixtral_8x7b.SMOKE_CONFIG,
        "qwen2": qwen2_0_5b.SMOKE_CONFIG}
MESHES = {"pod": ((2, 4, 1), ("pod", "data", "model")),
          "data_dp": ((2, 4), ("data", "model"))}
inputs_path, out_path = sys.argv[1], sys.argv[2]
inputs = dict(np.load(inputs_path))
steps, seq, gb = (int(a) for a in sys.argv[3:6])
aux = float(sys.argv[6])
out = {}

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in paths(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, np.asarray(tree))]

for run in sys.argv[7].split(","):
    arch, layout = run.split(":")
    mesh = compat.make_mesh(*MESHES[layout])
    tcfg = TrainConfig(agent_layout=layout, gossip="sparse", microbatch=2,
                       learning_rate=0.05, moe_aux_weight=aux)
    with compat.set_mesh(mesh):
        art = build_train_artifacts(CFGS[arch], tcfg,
                                    ShapeConfig("split", seq, gb, "train"),
                                    mesh, inputs["w_pair"])
        step = art.jit(donate=False)
        state = art.init_state(jax.random.key(0))
        for p, a in paths(state["params"]):
            out[f"{arch}/init/{p}"] = a[0]
        losses = []
        for k in range(steps):
            state, met = step(state, {"tokens": inputs[f"tokens/{arch}/{k}"]})
            losses.append(float(met["loss"]))
    out[f"{arch}/losses"] = np.asarray(losses)
    for p, a in paths(state["params"]):
        out[f"{arch}/params/{p}"] = a
    for p, a in paths(state["opt"]["momentum"]):
        out[f"{arch}/momentum/{p}"] = a
np.savez(out_path, **out)
print("JAX_SPLIT_OK")
"""


def _make_inputs(path: pathlib.Path) -> dict:
    m = 2
    out = {"w_pair": np.asarray([[0.625, 0.375], [0.375, 0.625]])}
    seq = rank_script.POD_TRAIN_SEQ
    # the reference's init_state: agent 0's model.init, split(key, m)[0]
    key = jax.random.split(jax.random.key(0), m)[0]
    for arch, cfg in JCFGS.items():
        for p, a in tree_paths(jax.tree.map(np.asarray,
                                            jmodel.init(cfg, key))):
            out[f"init/{arch}/{p}"] = a
        stream = SyntheticTokenStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, num_agents=m, seed=1))
        shapes = jtrain._batch_shapes(
            cfg, jbase.ShapeConfig("split", seq, rank_script.SPLIT_BATCH,
                                   "train"), m, 2)
        batch_fn = make_batch_fn(stream, shapes, cfg.vocab_size)
        for k in range(rank_script.STEPS):
            out[f"tokens/{arch}/{k}"] = batch_fn(k)["tokens"]
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multirank_split")
    inputs = work / "inputs.npz"
    with _x64_off():
        given = _make_inputs(inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    ref_path = work / "reference.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(inputs), str(ref_path),
         str(rank_script.STEPS), str(rank_script.POD_TRAIN_SEQ),
         str(rank_script.SPLIT_BATCH), str(rank_script.POD_AUX),
         ",".join(":".join(v) for v in rank_script.SPLIT_RUNS.values())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=env)
    rank_env = {**os.environ, "OMP_NUM_THREADS": "1"}
    ranks = {}
    for case in CASES:
        out_dir = work / case
        out_dir.mkdir()
        init = f"file://{work / (case + '.rendezvous')}"
        procs = [
            subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_rank.py"),
                 case, str(r), str(WORLD), init, str(inputs), str(out_dir),
                 *FAULTS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=str(ROOT), env=rank_env)
            for r in range(WORLD)
        ]
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0 and "RANK_OK" in log, log[-4000:]
        ranks[case] = []
        for r in range(WORLD):
            with np.load(out_dir / f"rank{r}.npz") as data:
                ranks[case].append(dict(data))
    log, _ = jax_proc.communicate(timeout=TIMEOUT)
    assert "JAX_SPLIT_OK" in log, log[-4000:]
    with np.load(ref_path) as data:
        ref = dict(data)
    return given, ref, ranks


def _errors(ref: dict, out: dict, case: str, prefix: str = "") -> dict:
    """Each quantity's worst error over its limit (≤ 1 passes): the whole
    tree a rank gathers against the reference's."""
    arch, layout = rank_script.SPLIT_RUNS[case]
    losses = ref[f"{arch}/losses"]
    got = out[f"{prefix}losses"]
    errs = {"loss": float((np.abs(got - losses) / np.abs(losses)).max())
            / LOSS_RTOL}
    for part in ("params", "momentum"):
        w = _section(ref, f"{arch}/{part}/")
        g = _section(out, f"{prefix}{part}/")
        assert w.keys() == g.keys()
        worst = 0.0
        for k in w:
            limit = STATE_ATOL
            if layout == "data_dp" and part == "momentum":
                # one bf16 ulp of the leaf's largest gradient more
                limit += 2.0**-7 * float(np.abs(w[k]).max())
            worst = max(worst, float(np.abs(g[k] - w[k]).max()) / limit)
        errs[part] = worst
    return errs


@pytest.mark.parametrize("case", CASES)
def test_split_train_matches_jax(runs, case):
    given, ref, ranks = runs
    arch = rank_script.SPLIT_RUNS[case][0]
    for k, v in _section(given, f"init/{arch}/").items():   # the same start
        np.testing.assert_array_equal(ref[f"{arch}/init/{k}"], v)
    outs = ranks[case]
    held = {}
    for out in outs:
        assert str(out["resolved"]) == "sparse"
        n, mb, g, start, stop = out["split"].tolist()
        assert (n, mb, g) == (4, 2, 2)
        assert int(out["local_rows"]) == stop - start == mb // g == 1
        held[(start, stop)] = held.get((start, stop), 0) + 1
    # over the 8 ranks (2 agents x 4 ranks of the batch role): each row
    # of an agent's microbatch on n / g = 2 ranks of each agent
    assert held == {(0, 1): 4, (1, 2): 4}
    errs = _errors(ref, outs[0], case)
    assert max(errs.values()) <= 1.0, errs
    for out in outs[1:]:
        for k, v in _section(outs[0], "params/").items():
            np.testing.assert_array_equal(out[f"params/{k}"], v)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fault", FAULTS)
def test_split_train_faults_are_refused(runs, case, fault):
    _, ref, ranks = runs
    errs = _errors(ref, ranks[case][0], case, f"fault/{fault}/")
    assert max(errs["params"], errs["loss"]) > 1.0, errs


# ---------------------------------------------------------------------------
# the rule alone
# ---------------------------------------------------------------------------


RULE_CASES = [(mb, n) for mb in (1, 2, 3, 4, 6, 8, 16, 24)
              for n in (1, 2, 4, 6, 16)]


@pytest.mark.parametrize("mb,n", RULE_CASES)
def test_every_row_is_held_by_n_over_g_ranks(mb, n):
    split = train.RowSplit(("model",), n, mb)
    g = math.gcd(mb, n)
    assert split.groups == g and split.weight == 1.0 / n
    assert split.copied == (g == 1 and n > 1)
    count = np.zeros(mb, int)
    for i in range(n):
        rows = split.rows_at(i)
        assert rows.stop - rows.start == mb // g
        count[rows] += 1
    assert (count == n // g).all()


def _host_art(mesh, layout: str, gb: int, seq: int = 4):
    """What ``local_batch`` reads of the artifacts on a host mesh
    description: the reference's batch specs and the rule; and the batch
    shapes."""
    shapes = train._batch_shapes(
        rank_script.CFG, base.ShapeConfig("rule", seq, gb, "train"),
        mesh_lib.num_agents(mesh, layout), 2)
    art = types.SimpleNamespace(
        batch_specs=train._batch_specs(shapes, mesh, layout),
        row_split=train.row_split(shapes, mesh, layout),
        num_agents=mesh_lib.num_agents(mesh, layout))
    return shapes, art


def _coords(mesh):
    names = list(mesh.shape)
    for flat in np.ndindex(*mesh.shape.values()):
        yield dict(zip(names, flat))


# (layout, mesh shape, axes, global batch): 2 microbatches an agent of mb
# rows over the batch role's n ranks
LOCAL_CASES = [
    ("data_dp", (2, 4), ("data", "model"), 16, 4),    # mb 4 over 4: g = n
    ("data_dp", (2, 4), ("data", "model"), 8, 2),     # mb 2 over 4: g = 2
    ("data_dp", (2, 4), ("data", "model"), 4, 1),     # mb 1 over 4: g = 1
    ("pod", (2, 4, 2), ("pod", "data", "model"), 8, 2),
    ("pod", (2, 4, 2), ("pod", "data", "model"), 16, 4),
    ("data", (4, 2), ("data", "model"), 16, 2),       # no batch role
]


@pytest.mark.parametrize("layout,shape,axes,gb,mb", LOCAL_CASES)
def test_local_batch_tiles_each_agents_rows(layout, shape, axes, gb, mb):
    """``local_batch`` at every coordinate: the agent's rows of the
    reference's spec, and of each microbatch the rule's rows — at g = n
    exactly ``shard_tree``'s part under the reference's spec, at g = 1
    the whole microbatch."""
    mesh = mesh_lib.make_test_mesh(shape, axes)
    shapes, art = _host_art(mesh, layout, gb)
    tokens = torch.arange(math.prod(shapes["tokens"].shape),
                          dtype=torch.int32).reshape(shapes["tokens"].shape)
    split = art.row_split
    assert split.rows == mb
    n, g = split.ranks, split.groups
    seen = {}
    for coords in _coords(mesh):
        got = train.local_batch(art, {"tokens": tokens}, mesh, coords)
        agent = mesh_lib.agent_index(
            mesh, mesh_lib.agent_axes(mesh, layout), coords)
        assert got["tokens"].shape[2] == mb // g
        if g == n:
            want = sharding.shard_tree({"tokens": tokens}, art.batch_specs,
                                       mesh, coords)
            assert torch.equal(got["tokens"], want["tokens"])
        if g == 1:
            assert torch.equal(got["tokens"][0], tokens[agent])
        for row in got["tokens"][0, 0, :, 0].tolist():
            seen[row] = seen.get(row, 0) + 1
    # every row of every agent's first microbatch, each on n / g ranks of
    # each coordinate off the batch role's axes and the agent's
    others = math.prod(shape) // (art.num_agents * n)
    first = tokens[:, 0, :, 0].reshape(-1).tolist()
    assert sorted(seen) == sorted(first)
    assert set(seen.values()) == {others * n // g}
