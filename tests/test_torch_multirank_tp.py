"""Tensor parallelism over "model" inside an agent, in gloo processes on
the CPU, against the JAX package's 8-device GSPMD runs.

The test writes one `npz` of inputs (the reference's initial parameters of
the smoke Qwen2, Mixtral, Jamba and Gemma2, tokens, the ring W), runs the
reference in one subprocess that forces 8 host devices before importing
jax, and beside it the port's ranks (`tests/_torch_rank.py`, one process a
rank, one `file://` rendezvous a group):

* (e) `tp_train`: 3 launcher steps of the `data` layout on a (4, 2) mesh,
  `sparse` gossip over the ring, for smoke Qwen2 (QKV bias, 4/2 heads),
  Mixtral (experts split along F) and Jamba (Mamba, `in_proj` gathered for
  its `[u | z]`), each rank holding its agent's `model` part of every
  leaf (`sharding.shard_tree` of the reference's stacked tree);
* (f) `tp_serve`: a prefill and 4 decode steps of smoke Qwen2 at (1, 4)
  (2 KV heads over 4 ranks: `wk`/`wv` gathered, each rank on one query
  head and its KV head) and of smoke Gemma2 (window, softcaps) and
  Mixtral at (2, 2);
* (g) `tp_units`, at 2 ranks: the conjugate pair against a whole-tensor
  computation, the vocabulary-parallel cross-entropy against the whole
  one, and the expert choices of every rank.

Limits: losses rtol 1e-4, parameters and momentum atol 1e-4 after 3 steps
(`tests/test_torch_multirank.py`'s); serving 1e-4. Faulty controls put in
by the rank script must be refused by the same comparisons: one rank
keeping its own partial sum after `wo` (it still joins the all-reduce, so
nothing hangs), Jamba's `in_proj` split taken as `[u | z]` where it lies,
and a forward reduce whose backward sums again
(`torch.distributed.nn.functional.all_reduce`).
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import gemma2_2b as jgemma2
from repro.configs import jamba_1_5_large_398b as jjamba
from repro.configs import mixtral_8x7b as jmixtral
from repro.configs import qwen2_0_5b as jqwen2
from repro.data.pipeline import make_batch_fn
from repro.data.synthetic import DataConfig, SyntheticTokenStream
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch.configs import qwen2_0_5b
from repro_torch.models import attention, model
from repro_torch.models import sharding_hints as sh
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

import _torch_rank as rank_script
from test_torch_multirank import ROOT, TIMEOUT, _section, _x64_off

LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4
SERVE_TOL = 1e-4
UNIT_TOL = 1e-5

JCFGS = {"qwen2": jqwen2.SMOKE_CONFIG, "mixtral": jmixtral.SMOKE_CONFIG,
         "jamba": jjamba.SMOKE_CONFIG, "gemma2": jgemma2.SMOKE_CONFIG}

# case -> (world size, faults its rank script puts in)
CASES = {
    "tp_train": (8, ("naive_uz",)),
    "tp_serve": (4, ("own_wo_partial",)),
    "tp_units": (2, ()),
}

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, numpy as np
from repro import compat
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs import gemma2_2b, jamba_1_5_large_398b, mixtral_8x7b, qwen2_0_5b
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_serve_artifacts
from repro.launch.train import build_train_artifacts

CFGS = {"qwen2": qwen2_0_5b.SMOKE_CONFIG, "mixtral": mixtral_8x7b.SMOKE_CONFIG,
        "jamba": jamba_1_5_large_398b.SMOKE_CONFIG,
        "gemma2": gemma2_2b.SMOKE_CONFIG}
inputs_path, out_path = sys.argv[1], sys.argv[2]
inputs = dict(np.load(inputs_path))
steps, seq, gb, decode_steps, prompt, max_len, b = (int(a) for a in sys.argv[3:10])
train_archs, serve_runs = sys.argv[10].split(","), sys.argv[11].split(",")
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

# (e) the data layout at (4, 2)
mesh = make_test_mesh((4, 2))
for arch in train_archs:
    tcfg = TrainConfig(agent_layout="data", gossip="sparse", microbatch=2,
                       learning_rate=0.05)
    with compat.set_mesh(mesh):
        art = build_train_artifacts(CFGS[arch], tcfg,
                                    ShapeConfig("tp", seq, gb, "train"), mesh,
                                    inputs["w_ring"])
        step = art.jit(donate=False)
        state = art.init_state(jax.random.key(0))
        losses = []
        for k in range(steps):
            state, met = step(state, {"tokens": inputs[f"tokens/{arch}/{k}"]})
            losses.append(float(met["loss"]))
    out[f"train/{arch}/losses"] = np.asarray(losses)
    for p, a in paths(state["params"]):
        out[f"train/{arch}/params/{p}"] = a
    for p, a in paths(state["opt"]["momentum"]):
        out[f"train/{arch}/momentum/{p}"] = a

# (f) serving at (1, 4) and (2, 2)
for run in serve_runs:
    arch, d, m = run.split(":")
    mesh = make_test_mesh((int(d), int(m)))
    cfg, params = CFGS[arch], nest(f"init/{arch}/")
    tokens = inputs[f"serve/tokens/{arch}"]
    with compat.set_mesh(mesh):
        pre = build_serve_artifacts(cfg, ShapeConfig("s", max_len, b, "prefill"),
                                    mesh)
        dec = build_serve_artifacts(cfg, ShapeConfig("s", max_len, b, "decode"),
                                    mesh)
        logits, caches = pre.jit()(params, {"tokens": tokens[:, :prompt]})
        got = [np.asarray(logits)]
        step = dec.jit(donate=False)
        for t in range(decode_steps):
            logits, caches = step(params, caches,
                                  tokens[:, prompt + t:prompt + t + 1])
            got.append(np.asarray(logits))
    out[f"serve/{run}/logits"] = np.stack(got)
np.savez(out_path, **out)
print("JAX_TP_OK")
"""


def _make_inputs(path: pathlib.Path) -> dict:
    m = 4
    out = {}
    ring = np.zeros((m, m))
    for i in range(m):
        ring[i, i] = 0.5
        ring[i, (i + 1) % m] = ring[(i + 1) % m, i] = 0.25
    out["w_ring"] = ring
    rng = np.random.default_rng(0)
    _, seq, gb = rank_script.TP_TRAIN_SHAPE
    archs = set(rank_script.TP_TRAIN_ARCHS) | {
        run.split(":")[0] for run in rank_script.TP_SERVE_RUNS}
    for arch in sorted(archs):
        cfg = JCFGS[arch]
        # the reference's init_state: agent 0's model.init, split(key, m)[0]
        key = jax.random.split(jax.random.key(0), m)[0]
        for p, a in tree_paths(jax.tree.map(np.asarray,
                                            jmodel.init(cfg, key))):
            out[f"init/{arch}/{p}"] = a
        stream = SyntheticTokenStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, num_agents=m, seed=1))
        shapes = jtrain._batch_shapes(
            cfg, jbase.ShapeConfig("tp", seq, gb, "train"), m, 2)
        batch_fn = make_batch_fn(stream, shapes, cfg.vocab_size)
        for k in range(rank_script.STEPS):
            out[f"tokens/{arch}/{k}"] = batch_fn(k)["tokens"]
        out[f"serve/tokens/{arch}"] = rng.integers(
            0, cfg.vocab_size, (rank_script.TP_SERVE_BATCH,
                                rank_script.SERVE_MAX_LEN)).astype(np.int32)
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
    work = tmp_path_factory.mktemp("multirank_tp")
    inputs = work / "inputs.npz"
    with _x64_off():
        given = _make_inputs(inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    ref_path = work / "reference.npz"
    _, seq, gb = rank_script.TP_TRAIN_SHAPE
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(inputs), str(ref_path),
         str(rank_script.STEPS), str(seq), str(gb),
         str(rank_script.DECODE_STEPS), str(rank_script.SERVE_PROMPT),
         str(rank_script.SERVE_MAX_LEN), str(rank_script.TP_SERVE_BATCH),
         ",".join(rank_script.TP_TRAIN_ARCHS),
         ",".join(rank_script.TP_SERVE_RUNS)],
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
    assert "JAX_TP_OK" in log, log[-4000:]
    with np.load(ref_path) as data:
        ref = dict(data)
    return given, ref, ranks


# ---------------------------------------------------------------------------
# (e) the data layout at model = 2
# ---------------------------------------------------------------------------


def _train_errors(ref: dict, rank0: dict, arch: str, prefix: str = "") -> dict:
    """Each quantity's worst error over its limit (≤ 1 passes): the whole
    tree every rank gathers (``gather_tree``) against the reference's."""
    want = f"train/{arch}/"
    losses = ref[want + "losses"]
    got = rank0[f"{prefix}{arch}/losses"]
    errs = {"loss": float((np.abs(got - losses) / np.abs(losses)).max())
            / LOSS_RTOL}
    for part in ("params", "momentum"):
        w = _section(ref, want + part + "/")
        g = _section(rank0, f"{prefix}{arch}/{part}/")
        assert w.keys() == g.keys()
        errs[part] = max(float(np.abs(g[k] - w[k]).max()) for k in w) \
            / STATE_ATOL
    return errs


@pytest.mark.parametrize("arch", rank_script.TP_TRAIN_ARCHS)
def test_tp_train_matches_jax(runs, arch):
    _, ref, ranks = runs
    for out in ranks["tp_train"]:
        assert str(out[f"{arch}/resolved"]) == "sparse"
    errs = _train_errors(ref, ranks["tp_train"][0], arch)
    assert max(errs.values()) <= 1.0, errs
    # every rank gathered the same whole tree
    for out in ranks["tp_train"][1:]:
        for k, v in _section(ranks["tp_train"][0], f"{arch}/params/").items():
            np.testing.assert_array_equal(out[f"{arch}/params/{k}"], v)


@pytest.mark.parametrize("arch", rank_script.TP_TRAIN_ARCHS)
def test_tp_train_gather_tree_is_the_reference_start(runs, arch):
    """``shard_tree`` then ``gather_tree`` of the reference's stacked
    initial tree gives it back bitwise, on every rank."""
    given, _, ranks = runs
    want = _section(given, f"init/{arch}/")
    for out in ranks["tp_train"]:
        got = _section(out, f"{arch}/init_gathered/")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.stack([want[k]] * 4))


@pytest.mark.parametrize("arch", rank_script.TP_TRAIN_ARCHS)
def test_tp_train_replicated_leaves_agree_across_model_ranks(runs, arch):
    """The leaves the rule leaves whole (norms, the router, ...) get the
    same gradient on both ``model`` ranks of an agent through the
    conjugate pair, with no all-reduce of their own: after 3 steps their
    parameters and momentum are bitwise equal."""
    _, _, ranks = runs
    by_agent: dict = {}
    for out in ranks["tp_train"]:
        by_agent.setdefault(int(out["agent"]), []).append(out)
    replicated = _section(ranks["tp_train"][0], f"{arch}/replicated/")
    assert replicated, "no replicated leaf recorded"
    for outs in by_agent.values():
        assert len(outs) == 2
        for k in replicated:
            np.testing.assert_array_equal(
                outs[0][f"{arch}/replicated/{k}"],
                outs[1][f"{arch}/replicated/{k}"])


@pytest.mark.parametrize("arch", [a for a in rank_script.TP_TRAIN_ARCHS
                                  if a in ("mixtral", "jamba")])
def test_tp_train_expert_choices_agree_across_model_ranks(runs, arch):
    """Every rank routes its agent's tokens alike: the expert ids of every
    ``moe.route`` call of the first step are equal on both ``model``
    ranks of an agent."""
    _, _, ranks = runs
    by_agent: dict = {}
    for out in ranks["tp_train"]:
        by_agent.setdefault(int(out["agent"]), []).append(
            out[f"{arch}/experts"])
    for a, (first, second) in by_agent.items():
        assert first.size > 0
        np.testing.assert_array_equal(first, second)


def test_tp_train_naive_uz_split_is_refused(runs):
    _, ref, ranks = runs
    errs = _train_errors(ref, ranks["tp_train"][0], "jamba",
                         "fault/naive_uz/")
    assert errs["params"] > 1.0, errs


# ---------------------------------------------------------------------------
# (f) serving's 1-D tensor parallelism
# ---------------------------------------------------------------------------


def _served(ranks: list, run: str, prefix: str = "") -> np.ndarray:
    """The logits of every call: each rank's at its rows (all rows where
    the batch does not split over "data"), equal across "model"."""
    outs = [(tuple(int(c) for c in o[f"{run}/coords"]), o) for o in ranks]
    rows = {}
    for (d, _), o in outs:
        got = o[f"{prefix}{run}/logits"]
        if d in rows and not prefix:
            np.testing.assert_array_equal(got, rows[d])
        rows.setdefault(d, got)
    if not bool(ranks[0][f"{run}/split"]):
        return rows[0]
    return np.concatenate([rows[d] for d in sorted(rows)], axis=1)


@pytest.mark.parametrize("run", rank_script.TP_SERVE_RUNS)
def test_tp_serve_matches_jax(runs, run):
    _, ref, ranks = runs
    got = _served(ranks["tp_serve"], run)
    want = ref[f"serve/{run}/logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL)


@pytest.mark.parametrize("run", rank_script.TP_SERVE_RUNS)
def test_tp_serve_gathers_only_misaligned_leaves(runs, run):
    """Qwen2 at (1, 4) holds half a KV head a rank: `wk`/`wv` (and their
    biases) are gathered at every use, counted; the aligned splits gather
    nothing."""
    _, _, ranks = runs
    arch, _, m = run.split(":")
    for out in ranks["tp_serve"]:
        counts = dict(zip([str(k) for k in out[f"{run}/gather_names"]],
                          out[f"{run}/gather_counts"].tolist()))
        if (arch, m) == ("qwen2", "4"):
            # 2 leaves (kernel, bias) x 2 projections x 2 layers x 5 calls
            assert counts == {"attention/wk": 20, "attention/wv": 20}
        else:
            assert counts == {}


def test_tp_serve_own_wo_partial_is_refused(runs):
    _, ref, ranks = runs
    run = rank_script.TP_SERVE_RUNS[0]
    got = _served(ranks["tp_serve"], run, "fault/own_wo_partial/")
    assert not np.allclose(got, ref[f"serve/{run}/logits"], rtol=SERVE_TOL,
                           atol=SERVE_TOL)


# ---------------------------------------------------------------------------
# (g) units at 2 ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["y", "grad_x", "grad_w1", "grad_w2"])
def test_conjugate_pair_matches_whole(runs, what):
    _, _, ranks = runs
    for out in ranks["tp_units"]:
        np.testing.assert_allclose(out[f"pair/{what}"],
                                   out[f"whole/{what}"], rtol=UNIT_TOL,
                                   atol=UNIT_TOL)


def test_summing_backward_is_refused(runs):
    """A forward reduce whose backward sums again (``torch.distributed.nn
    .functional.all_reduce``) counts the replicated gradient twice."""
    _, _, ranks = runs
    for out in ranks["tp_units"]:
        np.testing.assert_allclose(out["summing/y"], out["whole/y"],
                                   rtol=UNIT_TOL, atol=UNIT_TOL)
        assert not np.allclose(out["summing/grad_w1"], out["whole/grad_w1"],
                               rtol=UNIT_TOL, atol=UNIT_TOL)


@pytest.mark.parametrize("what", ["nll", "grad_logits"])
def test_vocab_parallel_cross_entropy_matches_whole(runs, what):
    _, _, ranks = runs
    for out in ranks["tp_units"]:
        np.testing.assert_allclose(out[f"ce/{what}"], out[f"ce_whole/{what}"],
                                   rtol=UNIT_TOL, atol=UNIT_TOL)


def test_unit_expert_choices_agree_across_ranks(runs):
    _, _, ranks = runs
    first, second = (out["moe/experts"] for out in ranks["tp_units"])
    assert first.size > 0
    np.testing.assert_array_equal(first, second)
    for out in ranks["tp_units"]:
        np.testing.assert_allclose(out["moe/y"], out["moe_whole/y"],
                                   rtol=UNIT_TOL, atol=UNIT_TOL)


# ---------------------------------------------------------------------------
# Without hints: the one-card paths as they were
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["copy_to_tp", "reduce_from_tp",
                                "gather_from_tp", "reduce_max_from_tp",
                                "take", "carry", "gather_from_fsdp",
                                "gather_fsdp", "batch_mean"])
def test_without_hints_the_tp_functions_return_their_input(fn):
    x = torch.randn(4, 6, requires_grad=True)
    if fn == "gather_from_tp":
        assert sh.gather_from_tp(x, -1) is x
    elif fn == "gather_from_fsdp":
        assert sh.gather_from_fsdp(x, 0) is x
    elif fn == "gather_fsdp":
        tree = {"kernel": x}
        assert sh.gather_fsdp(tree, "blocks", lead=1) is tree
    elif fn == "take":
        assert sh.take(x, -1, 0, 6, 6, True) is x
    elif fn == "carry":
        assert sh.carry(len) is len
    else:
        assert getattr(sh, fn)(x) is x
    assert sh.tp() is None and sh.dp() is None


@pytest.mark.parametrize("what", ["loss", "grads", "prefill", "decode"])
def test_without_a_tp_context_the_model_is_unchanged(what):
    """Hints installed on a one-card ``Mesh`` description (no process
    group, so no TP context) and no hints at all run the same ops:
    bitwise equal loss, gradients, prefill and decode logits."""
    from repro_torch.launch import mesh as mesh_lib
    cfg = qwen2_0_5b.SMOKE_CONFIG
    params = model.init(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 13),
                           generator=torch.Generator().manual_seed(3))

    def run():
        if what in ("loss", "grads"):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss, _ = model.loss(cfg, tree_unflatten(params, leaves),
                                 {"tokens": tokens})
            if what == "loss":
                return [loss.detach()]
            return list(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            logits, caches = model.prefill(cfg, params,
                                           {"tokens": tokens[:, :12]}, 16)
            if what == "prefill":
                return [logits]
            return [model.decode_step(cfg, params, caches,
                                      tokens[:, 12:13])[0]]

    plain = run()
    with sh.hints({"tp": ("model",), "batch": ()},
                  mesh_lib.make_test_mesh((1, 2))):
        assert sh.tp() is None
        hinted = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, hinted))


def test_gathered_leaves_are_named():
    """Every leaf the TP forms may gather has a stated reason."""
    assert set(sh.GATHERED_LEAVES) == {
        "attention/wq", "attention/wk", "attention/wv", "mamba/in_proj",
        "frontend/patch_proj", "slstm/wo"}
    class _Ctx:
        index, size = 0, 2

    token = sh._TP.set(_Ctx())
    with pytest.raises(ValueError, match="not a gathered leaf"):
        sh.take(torch.zeros(4, 3), -1, 3, 6, 6, False, "attention/wo")
    sh._TP.reset(token)


def test_head_plan_covers_wo_rows_with_even_groups():
    """Qwen2-0.5B's 14 heads on 2 KV heads at T = 4: each rank's
    ``wo`` rows (3.5 heads) are covered by whole query heads all on one
    KV head, so the local group stays even."""
    spec = attention.AttnSpec(896, 14, 2, 64, None, 1e6, None, True)

    class _Ctx:
        size = 4

    plans = []
    for index in range(4):
        ctx = _Ctx()
        ctx.index = index
        token = sh._TP.set(ctx)
        plans.append(attention.head_plan(
            {"wo": {"kernel": torch.empty(224, 896, device="meta")}}, spec))
        sh._TP.reset(token)
    assert [(p.q0, p.q1, p.k0, p.k1) for p in plans] == [
        (0, 4, 0, 1), (3, 7, 0, 1), (7, 11, 1, 2), (10, 14, 1, 2)]
    assert all(p.partial and p.hi - p.lo == 224 for p in plans)
