"""The port's D-PSGD across ranks and its batch-parallel serving, in gloo
processes on the CPU, against the JAX package's 8-device runs.

The test writes one `npz` of inputs (the reference's initial parameters of
the smoke Qwen2, tokens, the mixing matrices), then runs the reference in
one subprocess that forces 8 host devices before importing jax (as
`tests/test_multidevice.py` does) and, beside it, the port's ranks
(`tests/_torch_rank.py`, one process a rank, one `file://` rendezvous a
run):

* (a) `mix_sparse_shardmap` on a (2, 2, 2) mesh with agents on
  ("pod", "data") and the leaf's last dim over "model", for two W (one of
  them leaves an agent receiving nothing), against `mix_sparse_p2p`;
* (b) 3 launcher steps on a (4, 1) mesh in the `data` layout, in the
  `sparse`, `dense` and `allreduce` modes;
* (c) 3 steps on a (4, 2) mesh in `data_dp`/`sparse` (`mix_sparse_flat`
  at 2 slices), for smoke Qwen2 and for smoke Mixtral with the
  load-balance loss at weight 1 (its top-1 share of tokens is a mean over
  the microbatch's rows, which `model` splits);
* (d) the (4, 1) serve mesh path: a prefill and 4 decode steps, at a batch
  that splits over "data" and at one that does not;
* at world size 1 (what one card runs over NCCL), the mesh paths against
  the port's own one-card paths, bitwise.

Limits: the gossip 1e-5 (the reference test's, `tests/test_multidevice.py`);
losses rtol 1e-4 and parameters / momentum atol 1e-4 after 3 steps, plus one
bf16 ulp of the gradients under `data_dp` (`tests/test_torch_train.py`);
serving 1e-4 (`tests/test_torch_serve.py`). Each faulty run of the rank
script (a dropped round, the `model` gradient sum skipped, one rank given
another agent's rows, the load-balance loss over a rank's own rows) must
be refused by the same comparison. The `pod` layout and serving's 2-D
tensor parallelism build (`tests/test_torch_multirank_pod.py` runs them),
and a spec naming one axis twice is refused.
"""

import contextlib
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs.mixtral_8x7b import SMOKE_CONFIG as JMOE_CFG
from repro.configs.qwen2_0_5b import SMOKE_CONFIG as JCFG
from repro.core.weight_opt import optimize_weights
from repro.data.pipeline import make_batch_fn
from repro.data.synthetic import DataConfig, SyntheticTokenStream
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch.models import model
from repro_torch.roofline.analysis import COLLECTIVES
from repro_torch.tree import tree_leaves, tree_paths

import _torch_rank as rank_script

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 600
GOSSIP_TOL = 1e-5
LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
SERVE_TOL = 1e-4
RING = [(0, 1), (1, 2), (2, 3), (0, 3)]

# case -> (world size, faults its rank script puts in)
CASES = {
    "gossip": (8, ("dropped_round",)),
    "train_data": (4, ("dropped_round", "wrong_rows")),
    "train_data_dp": (8, ("dropped_round", "no_model_reduce", "wrong_rows")),
    "train_data_dp_moe": (8, ("per_rank_me",)),
    "serve": (4, ("wrong_rows",)),
    "world1": (1, ()),
}

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs.mixtral_8x7b import SMOKE_CONFIG as moe_cfg
from repro.configs.qwen2_0_5b import SMOKE_CONFIG as cfg
from repro.core import gossip
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_serve_artifacts
from repro.launch.train import build_train_artifacts

inputs_path, out_path = sys.argv[1], sys.argv[2]
inputs = dict(np.load(inputs_path))
steps, decode_steps, prompt, max_len = (int(a) for a in sys.argv[3:7])
out = {}

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in paths(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, np.asarray(tree))]

def nest(prefix):
    tree = {}
    for k, v in inputs.items():
        if k.startswith(prefix):
            node = tree
            *head, last = k[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return tree

# (a) the sparse gossip on a (2, 2, 2) mesh
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
specs = {"a": P(("pod", "data"), None, "model")}
x = {"a": inputs["gossip/x"]}
for name in ("w_opt", "w_skew"):
    sched = gossip.build_schedule(inputs[f"gossip/{name}"])
    sharded = jax.device_put(
        x, {k: NamedSharding(mesh, s) for k, s in specs.items()})
    with compat.set_mesh(mesh):
        got = gossip.mix_sparse_shardmap(sharded, sched, mesh,
                                         ("pod", "data"), specs)
    out[f"gossip/{name}"] = np.asarray(got["a"])

# (b), (c) the launcher's steps
runs = {
    "train_data": ((4, 1), "data", (16, 8), cfg, 1e-2,
                   [("sparse", "sparse", "w_ring"), ("dense", "dense", "w_ring"),
                    ("allreduce", "allreduce", "w_j")]),
    "train_data_dp": ((4, 2), "data_dp", (16, 16), cfg, 1e-2,
                      [("sparse", "sparse", "w_ring")]),
    "train_data_dp_moe": ((4, 2), "data_dp", (16, 16), moe_cfg, 1.0,
                          [("sparse", "sparse", "w_ring")]),
}
for case, (mshape, layout, (seq, gb), c, aux, modes) in runs.items():
    mesh = make_test_mesh(mshape)
    shape = ShapeConfig(case, seq, gb, "train")
    for name, asked, w_key in modes:
        tcfg = TrainConfig(agent_layout=layout, gossip=asked, microbatch=2,
                           learning_rate=0.05, moe_aux_weight=aux)
        with compat.set_mesh(mesh):
            art = build_train_artifacts(c, tcfg, shape, mesh, inputs[w_key])
            step = art.jit(donate=False)
            state = art.init_state(jax.random.key(0))
            for p, a in paths(state["params"]):
                out[f"{case}/{name}/init/{p}"] = a[0]
            losses = []
            for k in range(steps):
                state, met = step(state, {"tokens": inputs[f"tokens/{case}/{k}"]})
                losses.append(float(met["loss"]))
        out[f"{case}/{name}/losses"] = np.asarray(losses)
        for p, a in paths(state["params"]):
            out[f"{case}/{name}/params/{p}"] = a
        for p, a in paths(state["opt"]["momentum"]):
            out[f"{case}/{name}/momentum/{p}"] = a

# (d) the serve mesh path
mesh = make_test_mesh((4, 1))
params = nest("init/")
for b in (4, 2):
    tokens = inputs[f"serve/tokens/{b}"]
    with compat.set_mesh(mesh):
        pre = build_serve_artifacts(cfg, ShapeConfig("serve", max_len, b,
                                                     "prefill"), mesh)
        dec = build_serve_artifacts(cfg, ShapeConfig("serve", max_len, b,
                                                     "decode"), mesh)
        logits, caches = pre.jit()(params, {"tokens": tokens[:, :prompt]})
        got = [np.asarray(logits)]
        step = dec.jit(donate=False)
        for t in range(decode_steps):
            logits, caches = step(params, caches,
                                  tokens[:, prompt + t:prompt + t + 1])
            got.append(np.asarray(logits))
    out[f"serve/{b}/logits"] = np.stack(got)
np.savez(out_path, **out)
print("JAX_MULTIRANK_OK")
"""


@contextlib.contextmanager
def _x64_off():
    """Float32 JAX, as the reference's own process runs: another test file
    in this worker may have switched x64 on, which changes what
    ``jax.random`` draws."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _inputs(path: pathlib.Path) -> dict:
    """The inputs both packages take, made once here."""
    with _x64_off():
        return _make_inputs(path)


def _make_inputs(path: pathlib.Path) -> dict:
    m = 4
    out = {}
    rng = np.random.default_rng(0)
    out["gossip/x"] = rng.standard_normal((m, 8, 6)).astype(np.float32)
    out["gossip/w_opt"] = np.asarray(optimize_weights(m, RING, steps=150).matrix)
    skew = np.eye(m)           # agent 3 receives nothing; 0 from 1, 2, 3
    skew[0] = [0.4, 0.2, 0.3, 0.1]
    skew[1, :2] = [0.5, 0.5]
    skew[2, 1:3] = [0.25, 0.75]
    out["gossip/w_skew"] = skew
    ring = np.zeros((m, m))
    for i in range(m):
        ring[i, i] = 0.5
        ring[i, (i + 1) % m] = ring[(i + 1) % m, i] = 0.25
    out["w_ring"], out["w_j"] = ring, np.full((m, m), 1.0 / m)
    # the reference's init_state: agent 0's model.init from split(key, m)[0]
    key = jax.random.split(jax.random.key(0), m)[0]
    for p, a in tree_paths(jax.tree.map(np.asarray, jmodel.init(JCFG, key))):
        out[f"init/{p}"] = a
    for p, a in tree_paths(jax.tree.map(np.asarray,
                                        jmodel.init(JMOE_CFG, key))):
        out[f"init_moe/{p}"] = a
    for case, (_, _, gb, _) in rank_script.TRAIN_SHAPES.items():
        c = JMOE_CFG if case == "train_data_dp_moe" else JCFG
        stream = SyntheticTokenStream(DataConfig(
            vocab_size=c.vocab_size, seq_len=16, num_agents=m, seed=1))
        shapes = jtrain._batch_shapes(
            c, jbase.ShapeConfig(case, 16, gb, "train"), m, 2)
        batch_fn = make_batch_fn(stream, shapes, c.vocab_size)
        for k in range(rank_script.STEPS):
            out[f"tokens/{case}/{k}"] = batch_fn(k)["tokens"]
    for b in rank_script.SERVE_BATCHES:
        out[f"serve/tokens/{b}"] = rng.integers(
            0, JCFG.vocab_size, (b, rank_script.SERVE_MAX_LEN)).astype(np.int32)
    np.savez(path, **out)
    return out


def _start_ranks(case: str, inputs: pathlib.Path, work: pathlib.Path):
    world, faults = CASES[case]
    out_dir = work / case
    out_dir.mkdir()
    init = f"file://{work / (case + '.rendezvous')}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return out_dir, [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_rank.py"), case,
             str(r), str(world), init, str(inputs), str(out_dir), *faults],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT), env=env)
        for r in range(world)
    ]


def _finish(procs) -> None:
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=TIMEOUT)
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "RANK_OK" in log, log[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multirank")
    inputs = work / "inputs.npz"
    given = _inputs(inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    ref_path = work / "reference.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(inputs), str(ref_path),
         str(rank_script.STEPS), str(rank_script.DECODE_STEPS),
         str(rank_script.SERVE_PROMPT), str(rank_script.SERVE_MAX_LEN)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=env)
    ranks = {}
    for case in CASES:
        out_dir, procs = _start_ranks(case, inputs, work)
        _finish(procs)
        ranks[case] = []
        for r in range(CASES[case][0]):
            with np.load(out_dir / f"rank{r}.npz") as data:
                ranks[case].append(dict(data))
    log, _ = jax_proc.communicate(timeout=TIMEOUT)
    assert "JAX_MULTIRANK_OK" in log, log[-4000:]
    with np.load(ref_path) as data:
        ref = dict(data)
    return given, ref, ranks


def _section(tree: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix)}


def _kinds(rank: dict, key: str) -> tuple[dict, dict]:
    """The bytes and calls by kind that a rank's run counted
    (``_torch_rank.record_collectives``)."""
    return (dict(zip(COLLECTIVES, rank[f"{key}coll_bytes"].tolist())),
            dict(zip(COLLECTIVES, rank[f"{key}coll_calls"].tolist())))


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _only(**kinds) -> dict:
    return {k: kinds.get(k.replace("-", "_"), 0) for k in COLLECTIVES}


# ---------------------------------------------------------------------------
# (a) the gossip
# ---------------------------------------------------------------------------


def _gossip_whole(ranks: list, key: str) -> np.ndarray:
    """The ranks' [1, 8, 3] shards put back at their coordinates."""
    whole = np.zeros((4, 8, 6), np.float32)
    for out in ranks:
        pod, data, model = (int(c) for c in out["coords"])
        whole[pod * 2 + data, :, model * 3:(model + 1) * 3] = out[key][0]
    return whole


@pytest.mark.parametrize("w", ["w_opt", "w_skew"])
def test_gossip_p2p_matches_shardmap(runs, w):
    given, ref, ranks = runs
    got = _gossip_whole(ranks["gossip"], w)
    want = ref[f"gossip/{w}"]
    assert float(np.abs(got - want).max()) < GOSSIP_TOL
    dense = np.einsum("ab,bij->aij", given[f"gossip/{w}"], given["gossip/x"])
    assert float(np.abs(got - dense).max()) < GOSSIP_TOL
    # gather_tree: every rank holds the whole mixed leaf
    for out in ranks["gossip"]:
        np.testing.assert_array_equal(out[f"{w}/gathered"], got)


@pytest.mark.parametrize("w", ["w_opt", "w_skew"])
def test_gossip_dropped_round_is_refused(runs, w):
    _, ref, ranks = runs
    got = _gossip_whole(ranks["gossip"], f"fault/dropped_round/{w}")
    assert float(np.abs(got - ref[f"gossip/{w}"]).max()) > GOSSIP_TOL


# ---------------------------------------------------------------------------
# (b), (c) the launcher's steps
# ---------------------------------------------------------------------------


def _train_errors(ref: dict, ranks: list, case: str, name: str,
                  prefix: str = "") -> dict:
    """Each quantity's worst error over its limit across the ranks (≤ 1
    passes), each rank against its agent's row of the reference."""
    want = f"{case}/{name}/"
    losses = ref[want + "losses"]
    errs = {"loss": 0.0, "params": 0.0, "momentum": 0.0}
    for out in ranks:
        a = int(out["agent"])
        got = out[prefix + name + "/losses"]
        errs["loss"] = max(errs["loss"], float(
            (np.abs(got - losses) / np.abs(losses)).max()) / LOSS_RTOL)
        for part in ("params", "momentum"):
            w = _section(ref, want + part + "/")
            g = _section(out, prefix + name + "/" + part + "/")
            assert w.keys() == g.keys()
            for k in w:
                limit = STATE_ATOL
                if case.startswith("train_data_dp") and part == "momentum":
                    # one bf16 ulp of the leaf's largest gradient more
                    limit += 2.0**-7 * float(np.abs(w[k][a]).max())
                errs[part] = max(errs[part], float(
                    np.abs(g[k][0] - w[k][a]).max()) / limit)
    return errs


TRAIN_RUNS = [("train_data", "sparse"), ("train_data", "dense"),
              ("train_data", "allreduce"), ("train_data_dp", "sparse"),
              ("train_data_dp_moe", "sparse")]


@pytest.mark.parametrize("case,name", TRAIN_RUNS)
def test_train_mesh_matches_jax(runs, case, name):
    given, ref, ranks = runs
    init = "init_moe/" if case == "train_data_dp_moe" else "init/"
    for k, v in _section(given, init).items():   # the same start
        np.testing.assert_array_equal(ref[f"{case}/{name}/init/{k}"], v)
    for out in ranks[case]:
        assert str(out[f"{name}/resolved"]) == name
    assert sorted(int(o["agent"]) for o in ranks[case]) == sorted(
        list(range(4)) * (len(ranks[case]) // 4))
    errs = _train_errors(ref, ranks[case], case, name)
    assert max(errs.values()) <= 1.0, errs


TRAIN_FAULTS = [(case, "sparse", fault) for case in ("train_data",
                                                     "train_data_dp",
                                                     "train_data_dp_moe")
                for fault in CASES[case][1]]


@pytest.mark.parametrize("case,name,fault", TRAIN_FAULTS)
def test_train_mesh_faults_are_refused(runs, case, name, fault):
    _, ref, ranks = runs
    errs = _train_errors(ref, ranks[case], case, name, f"fault/{fault}/")
    assert errs["params"] > 1.0, errs


UNPORTED = ["pod", "serve 2-D at data 2",
            "data at model 2 with a leaf over data"]


@pytest.mark.parametrize("what", UNPORTED)
def test_unported_layouts_raise(runs, what):
    """What the parent refused as ROADMAP A7b(ii) now builds on a
    ``DeviceMesh`` — the ``pod`` layout at (4, 2) and serving's 2-D
    tensor parallelism for Mixtral-8x7B at (2, 4), each with leaves over
    "data" — and a spec naming "data" twice is refused by ``shard_tree``
    with a ``ValueError`` naming the axis (the runs themselves:
    tests/test_torch_multirank_pod.py)."""
    _, _, ranks = runs
    i = UNPORTED.index(what)
    for out in ranks["train_data_dp"]:
        got = str(out["unported_raise"][i])
        if i < 2:
            assert got.startswith("built, ") and not got.startswith(
                "built, 0 "), got
        else:
            assert "uses the axis 'data' twice" in got, got


# ---------------------------------------------------------------------------
# (d) serving
# ---------------------------------------------------------------------------


def _serve_whole(ranks: list, b: int, prefix: str = "") -> np.ndarray:
    """Each rank's logits at its rows (all rows when B does not split)."""
    parts = [out[f"{prefix}{b}/logits"] for out in ranks]
    if not bool(ranks[0][f"{b}/split"]):
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0])
        return parts[0]
    return np.concatenate(parts, axis=1)    # ranks in "data" order


@pytest.mark.parametrize("b", rank_script.SERVE_BATCHES)
def test_serve_mesh_matches_jax(runs, b):
    _, ref, ranks = runs
    assert bool(ranks["serve"][0][f"{b}/split"]) == (b % 4 == 0)
    got = _serve_whole(ranks["serve"], b)
    want = ref[f"serve/{b}/logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL)


def test_serve_mesh_wrong_rows_are_refused(runs):
    _, ref, ranks = runs
    got = _serve_whole(ranks["serve"], 4, "fault/wrong_rows/")
    assert not np.allclose(got, ref["serve/4/logits"], rtol=SERVE_TOL,
                           atol=SERVE_TOL)


@pytest.mark.parametrize("what", ["train_bitwise", "flat_identity",
                                  "serve_bitwise"])
def test_world_size_one_is_the_one_card_path(runs, what):
    """What one card can run over NCCL, held here over gloo: at (1, 1) the
    mesh step and the serve mesh path equal the one-card paths bitwise,
    and the flat gossip at W = [1] returns the parameters."""
    _, _, ranks = runs
    assert bool(ranks["world1"][0][what])


# ---------------------------------------------------------------------------
# (e) the collective counter against bytes computed by hand
# ---------------------------------------------------------------------------


def test_sparse_gossip_sends_out_degree_times_the_agent(runs):
    """``data`` layout at (4, 1), W the 4-ring: each rank sends its whole
    agent to each of its 2 out-neighbours (one send a leaf and edge); the
    loss's mean is the step's one all-reduce (4 bytes). The dense mode
    gathers every leaf once, the all-reduce mode sums a float32 copy."""
    given, _, ranks = runs
    params = model.init(rank_script.CFG, 0, device="meta")
    whole, leaves = _bytes(params), len(tree_leaves(params))
    w = given["w_ring"]
    for r, rank in enumerate(ranks["train_data"]):
        out_degree = int(np.count_nonzero(w[:, r]) - 1)
        assert out_degree == 2
        sent, calls = _kinds(rank, "sparse/step0/")
        assert sent == _only(collective_permute=out_degree * whole,
                             all_reduce=4)
        assert calls == _only(collective_permute=out_degree * leaves,
                              all_reduce=1)
        sent, calls = _kinds(rank, "dense/step0/")
        assert sent == _only(all_gather=whole, all_reduce=4)
        assert calls == _only(all_gather=leaves, all_reduce=1)
        sent, calls = _kinds(rank, "allreduce/step0/")
        assert sent == _only(all_reduce=whole + 4)   # float32 leaves
        assert calls == _only(all_reduce=leaves + 1)
