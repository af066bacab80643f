"""FSDP and expert parallelism over "data" inside an agent — the `pod`
layout and serving's 2-D tensor parallelism — in gloo processes on the
CPU, against the JAX package's 8-device GSPMD runs.

The test writes one `npz` of inputs (the reference's initial parameters of
the smoke Mixtral, Jamba and LLaVA, tokens, patch embeddings, a 2-agent
W), runs the reference in one subprocess that forces 8 host devices before
importing jax, and beside it the port's ranks (`tests/_torch_rank.py`, one
process a rank, one `file://` rendezvous a group):

* (h) `pod_train`: 3 launcher steps of the `pod` layout on a (2, 2, 2)
  mesh — one agent a pod, FSDP and EP over "data", TP over "model",
  `sparse` gossip over the pods — for smoke Mixtral (E = 4 over 2 data
  ranks), Jamba (Mamba leaves under FSDP, EP, attention) and LLaVA
  (`patch_proj`), at microbatches of 2 rows (split over "data") and, for
  Mixtral, of 1 row (every data rank holds it), the load-balance loss at
  weight 1;
* (i) `pod_serve`: a prefill and 4 decode steps of smoke Mixtral and Jamba
  at (2, 2), B = 2 (rows split) and B = 1 (rows on every data rank), with
  `parameter_count` reporting 1e12 in both packages, so that both rules
  pick 2-D tensor parallelism at smoke width (patched at run time: the
  JAX package's files are not edited);
* `pod_units`, at 2 ranks over "data": FSDP's gather and EP's all-to-all
  pair against whole-tensor computations, forward and backward, and the
  load-balance loss with the router's gradient over split rows.

Limits: losses rtol 1e-4, parameters and momentum atol 1e-4 after 3 steps
(`tests/test_torch_multirank.py`'s); serving 1e-4; units 1e-5. Faulty
controls put in by the rank script must be refused by the same
comparisons: EP rows sent to the wrong owner, FSDP's backward keeping the
rank's own part without the sum, and the load-balance loss's `me` over the
rank's rows only.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import jamba_1_5_large_398b as jjamba
from repro.configs import llava_next_34b as jllava
from repro.configs import mixtral_8x7b as jmixtral
from repro.data.pipeline import make_batch_fn
from repro.data.synthetic import DataConfig, SyntheticTokenStream
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch.tree import tree_paths

import _torch_rank as rank_script
from test_torch_multirank import (ROOT, TIMEOUT, _kinds, _only, _section,
                                  _x64_off)

LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
SERVE_TOL = 1e-4
UNIT_TOL = 1e-5

JCFGS = {"mixtral": jmixtral.SMOKE_CONFIG, "jamba": jjamba.SMOKE_CONFIG,
         "llava": jllava.SMOKE_CONFIG}

# case -> (world size, faults its rank script puts in)
CASES = {
    "pod_train": (8, ("ep_wrong_rows", "fsdp_own_part", "per_rank_me")),
    "pod_serve": (4, ("ep_wrong_rows",)),
    "pod_units": (2, ()),
}
TRAIN_FAULTS = CASES["pod_train"][1]

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, numpy as np
from repro import compat
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs import jamba_1_5_large_398b, llava_next_34b, mixtral_8x7b
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_serve_artifacts
from repro.launch.train import build_train_artifacts
from repro.models import model as M

CFGS = {"mixtral": mixtral_8x7b.SMOKE_CONFIG,
        "jamba": jamba_1_5_large_398b.SMOKE_CONFIG,
        "llava": llava_next_34b.SMOKE_CONFIG}
inputs_path, out_path = sys.argv[1], sys.argv[2]
inputs = dict(np.load(inputs_path))
steps, seq, decode_steps, prompt, max_len = (int(a) for a in sys.argv[3:8])
aux, big = float(sys.argv[8]), int(sys.argv[9])
train_runs, serve_runs = sys.argv[10].split(","), sys.argv[11].split(",")
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

# (h) the pod layout at (2, 2, 2)
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
for run in train_runs:
    arch, gb = run.split(":")
    tcfg = TrainConfig(agent_layout="pod", gossip="sparse", microbatch=2,
                       learning_rate=0.05, moe_aux_weight=aux)
    with compat.set_mesh(mesh):
        art = build_train_artifacts(CFGS[arch], tcfg,
                                    ShapeConfig("pod", seq, int(gb), "train"),
                                    mesh, inputs["w_pair"])
        step = art.jit(donate=False)
        state = art.init_state(jax.random.key(0))
        losses = []
        for k in range(steps):
            batch = {"tokens": inputs[f"tokens/{run}/{k}"]}
            if f"patches/{run}/{k}" in inputs:
                batch["patch_embeds"] = inputs[f"patches/{run}/{k}"]
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
    out[f"train/{run}/losses"] = np.asarray(losses)
    for p, a in paths(state["params"]):
        out[f"train/{run}/params/{p}"] = a
    for p, a in paths(state["opt"]["momentum"]):
        out[f"train/{run}/momentum/{p}"] = a

# (i) serving's 2-D tensor parallelism at (2, 2)
M.parameter_count = lambda cfg, params=None: big
mesh = make_test_mesh((2, 2))
for run in serve_runs:
    arch, b = run.split(":")
    cfg, params = CFGS[arch], nest(f"init/{arch}/")
    tokens = inputs[f"serve/tokens/{run}"]
    with compat.set_mesh(mesh):
        pre = build_serve_artifacts(cfg, ShapeConfig("s", max_len, int(b),
                                                     "prefill"), mesh)
        dec = build_serve_artifacts(cfg, ShapeConfig("s", max_len, int(b),
                                                     "decode"), mesh)
        logits, caches = pre.jit()(params, {"tokens": tokens[:, :prompt]})
        got = [np.asarray(logits)]
        step = dec.jit(donate=False)
        for t in range(decode_steps):
            logits, caches = step(params, caches,
                                  tokens[:, prompt + t:prompt + t + 1])
            got.append(np.asarray(logits))
    out[f"serve/{run}/logits"] = np.stack(got)
np.savez(out_path, **out)
print("JAX_POD_OK")
"""


def _make_inputs(path: pathlib.Path) -> dict:
    m = 2
    out = {"w_pair": np.asarray([[0.625, 0.375], [0.375, 0.625]])}
    rng = np.random.default_rng(0)
    seq = rank_script.POD_TRAIN_SEQ
    for arch, cfg in JCFGS.items():
        # the reference's init_state: agent 0's model.init, split(key, m)[0]
        key = jax.random.split(jax.random.key(0), m)[0]
        for p, a in tree_paths(jax.tree.map(np.asarray,
                                            jmodel.init(cfg, key))):
            out[f"init/{arch}/{p}"] = a
    for run in rank_script.POD_TRAIN_RUNS:
        arch, gb = run.split(":")
        cfg = JCFGS[arch]
        stream = SyntheticTokenStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, num_agents=m, seed=1))
        shapes = jtrain._batch_shapes(
            cfg, jbase.ShapeConfig("pod", seq, int(gb), "train"), m, 2)
        batch_fn = make_batch_fn(stream, shapes, cfg.vocab_size)
        for k in range(rank_script.STEPS):
            batch = batch_fn(k)
            out[f"tokens/{run}/{k}"] = batch["tokens"]
            if "patch_embeds" in batch:
                out[f"patches/{run}/{k}"] = batch["patch_embeds"]
    for run in rank_script.POD_SERVE_RUNS:
        arch, b = run.split(":")
        out[f"serve/tokens/{run}"] = rng.integers(
            0, JCFGS[arch].vocab_size,
            (int(b), rank_script.SERVE_MAX_LEN)).astype(np.int32)
    np.savez(path, **out)
    return out


def _run_case(case: str, inputs: pathlib.Path, work: pathlib.Path):
    world, faults = CASES[case]
    out_dir = work / case
    out_dir.mkdir()
    init = f"file://{work / (case + '.rendezvous')}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_rank.py"), case,
             str(r), str(world), init, str(inputs), str(out_dir), *faults],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT), env=env)
        for r in range(world)
    ]
    return out_dir, procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multirank_pod")
    inputs = work / "inputs.npz"
    with _x64_off():
        given = _make_inputs(inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    ref_path = work / "reference.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(inputs), str(ref_path),
         str(rank_script.STEPS), str(rank_script.POD_TRAIN_SEQ),
         str(rank_script.DECODE_STEPS), str(rank_script.SERVE_PROMPT),
         str(rank_script.SERVE_MAX_LEN), str(rank_script.POD_AUX),
         str(rank_script.TWO_D_PARAMS),
         ",".join(rank_script.POD_TRAIN_RUNS),
         ",".join(rank_script.POD_SERVE_RUNS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=env)
    ranks = {}
    for case in CASES:
        out_dir, procs = _run_case(case, inputs, work)
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0 and "RANK_OK" in log, log[-4000:]
        ranks[case] = []
        for r in range(CASES[case][0]):
            with np.load(out_dir / f"rank{r}.npz") as data:
                ranks[case].append(dict(data))
    log, _ = jax_proc.communicate(timeout=TIMEOUT)
    assert "JAX_POD_OK" in log, log[-4000:]
    with np.load(ref_path) as data:
        ref = dict(data)
    return given, ref, ranks


# ---------------------------------------------------------------------------
# (h) the pod layout
# ---------------------------------------------------------------------------


def _train_errors(ref: dict, out: dict, run: str, prefix: str = "") -> dict:
    """Each quantity's worst error over its limit (≤ 1 passes): the whole
    tree a rank gathers (``gather_tree``) against the reference's."""
    want = f"train/{run}/"
    losses = ref[want + "losses"]
    got = out[f"{prefix}{run}/losses"]
    errs = {"loss": float((np.abs(got - losses) / np.abs(losses)).max())
            / LOSS_RTOL}
    for part in ("params", "momentum"):
        w = _section(ref, want + part + "/")
        g = _section(out, f"{prefix}{run}/{part}/")
        assert w.keys() == g.keys()
        errs[part] = max(float(np.abs(g[k] - w[k]).max()) for k in w) \
            / STATE_ATOL
    return errs


@pytest.mark.parametrize("run", rank_script.POD_TRAIN_RUNS)
def test_pod_train_matches_jax(runs, run):
    _, ref, ranks = runs
    outs = ranks["pod_train"]
    for out in outs:
        assert str(out[f"{run}/resolved"]) == "sparse"
        assert bool(out[f"{run}/split"]) == (run != "mixtral:4")
    errs = _train_errors(ref, outs[0], run)
    assert max(errs.values()) <= 1.0, errs
    # every rank gathered the same whole tree
    for out in outs[1:]:
        for k, v in _section(outs[0], f"{run}/params/").items():
            np.testing.assert_array_equal(out[f"{run}/params/{k}"], v)


@pytest.mark.parametrize("run", rank_script.POD_TRAIN_RUNS)
def test_pod_train_collectives(runs, run):
    """One step's data-parallel collectives on every rank: the FSDP
    gathers, and for the MoE archs one dispatch and one combine per MoE
    layer per microbatch, forward and recompute."""
    _, _, ranks = runs
    arch = run.split(":")[0]
    counts = {tuple(out[f"{run}/dp_counts"].tolist())
              for out in ranks["pod_train"]}
    assert len(counts) == 1
    combine, dispatch, gathers = counts.pop()   # sorted names
    cfg = rank_script.POD_CFGS[arch]
    moe_layers = sum(k.endswith("_moe") for k in cfg.block_pattern) \
        * cfg.num_groups
    # 2 microbatches, each MoE layer run forward and again in backward
    assert dispatch == combine == 2 * 2 * moe_layers
    assert gathers > 0


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_pod_train_faults_are_refused(runs, fault):
    _, ref, ranks = runs
    run = rank_script.POD_TRAIN_RUNS[0]
    errs = _train_errors(ref, ranks["pod_train"][0], run, f"fault/{fault}/")
    assert max(errs["params"], errs["loss"]) > 1.0, errs


# ---------------------------------------------------------------------------
# (i) serving's 2-D tensor parallelism
# ---------------------------------------------------------------------------


def _served(ranks: list, run: str, prefix: str = "") -> np.ndarray:
    """The logits of every call: each rank's at its rows (all rows where
    the batch does not split over "data"), equal across "model"."""
    rows = {}
    for o in ranks:
        d = int(o[f"{run}/coords"][0])
        got = o[f"{prefix}{run}/logits"]
        if d in rows and not prefix:
            np.testing.assert_array_equal(got, rows[d])
        rows.setdefault(d, got)
    if not bool(ranks[0][f"{run}/split"]):
        return rows[0]
    return np.concatenate([rows[d] for d in sorted(rows)], axis=1)


@pytest.mark.parametrize("run", rank_script.POD_SERVE_RUNS)
def test_pod_serve_matches_jax(runs, run):
    _, ref, ranks = runs
    outs = ranks["pod_serve"]
    assert bool(outs[0][f"{run}/split"]) == run.endswith(":2")
    assert int(outs[0][f"{run}/over_data"]) > 0
    got = _served(outs, run)
    want = ref[f"serve/{run}/logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL)


@pytest.mark.parametrize("run", rank_script.POD_SERVE_RUNS)
def test_pod_serve_collectives(runs, run):
    """A prefill and 4 decode steps: one dispatch and one combine per MoE
    layer per call, and the FSDP gathers of every group and of the
    embedding tables per call, on every rank."""
    _, _, ranks = runs
    arch = run.split(":")[0]
    cfg = rank_script.POD_CFGS[arch]
    calls = 1 + rank_script.DECODE_STEPS
    moe_layers = sum(k.endswith("_moe") for k in cfg.block_pattern) \
        * cfg.num_groups
    for out in ranks["pod_serve"]:
        combine, dispatch, gathers = out[f"{run}/dp_counts"].tolist()
        assert dispatch == combine == calls * moe_layers
        assert gathers > 0 and gathers % calls == 0


def test_pod_serve_ep_wrong_rows_are_refused(runs):
    _, ref, ranks = runs
    run = rank_script.POD_SERVE_RUNS[0]
    got = _served(ranks["pod_serve"], run, "fault/ep_wrong_rows/")
    assert not np.allclose(got, ref[f"serve/{run}/logits"], rtol=SERVE_TOL,
                           atol=SERVE_TOL)


# ---------------------------------------------------------------------------
# units at 2 ranks over "data"
# ---------------------------------------------------------------------------


UNITS = ["fsdp/y", "fsdp/grad", "ep/y", "ep/grad_x", "ep/grad_w",
         "balance/loss", "balance/grad"]


@pytest.mark.parametrize("what", UNITS)
def test_pod_unit_matches_whole(runs, what):
    _, _, ranks = runs
    name, part = what.split("/")
    for out in ranks["pod_units"]:
        np.testing.assert_allclose(out[what], out[f"{name}_whole/{part}"],
                                   rtol=UNIT_TOL, atol=UNIT_TOL)


def test_pod_unit_per_rank_me_is_refused(runs):
    """The load-balance loss with each rank's own top-1 share: the mean of
    products is not the product of means."""
    _, _, ranks = runs
    for out in ranks["pod_units"]:
        assert not np.allclose(out["fault/per_rank_me/balance/grad"],
                               out["balance_whole/grad"], rtol=UNIT_TOL,
                               atol=UNIT_TOL)


def test_fsdp_gather_and_ep_all_to_all_bytes(runs):
    """The collective counter on ``pod_units`` at 2 ranks over "data":
    FSDP's gather sends the local part ``[2, 6]`` (48 bytes), its backward
    reduce-scatters the whole gradient ``[4, 6]`` (96 bytes); EP's
    dispatch and combine each send the stack of parts of a ``[2, 4, 3,
    5]`` buffer (480 bytes), forward and backward."""
    _, _, ranks = runs
    for rank in ranks["pod_units"]:
        assert _kinds(rank, "fsdp/") == (
            _only(all_gather=48, reduce_scatter=96),
            _only(all_gather=1, reduce_scatter=1))
        assert _kinds(rank, "ep/") == (_only(all_to_all=4 * 480),
                                       _only(all_to_all=4))
