"""One rank of the port's runs across ranks (gloo on the CPU), started by
`tests/test_torch_multirank.py` once per rank:

    python tests/_torch_rank.py CASE RANK WORLD INIT_METHOD INPUTS OUT_DIR [FAULT ...]

CASE is `gossip` (a (2, 2, 2) mesh), `train_data` (a (4, 1) mesh, the
`data` layout in the sparse, dense and allreduce modes), `train_data_dp`
(a (4, 2) mesh, `data_dp`/sparse), `train_data_dp_moe` (the same for
smoke Mixtral with the load-balance loss at weight 1), `serve` (a (4, 1)
mesh), `world1`
(a (1, 1) mesh: the mesh paths against the one-card paths, which is all
one card can run over NCCL), `tp_train` (a (4, 2) mesh, the `data` layout
with each leaf split over "model", for smoke Qwen2, Mixtral and Jamba),
`tp_serve` (meshes (1, 4) and (2, 2), serving's 1-D tensor parallelism)
`tp_units` (a (1, 2) mesh: the conjugate pair, the
vocabulary-parallel cross-entropy and the MoE's routing), `pod_train` (a
(2, 2, 2) mesh, the `pod` layout: FSDP and EP over "data", TP over
"model", one agent a pod), `pod_serve` (a (2, 2) mesh, serving's 2-D
tensor parallelism) or `pod_units` (a (2, 1) mesh: FSDP's gather, EP's
all-to-all pair and the load-balance loss over split rows). INPUTS is
the test's `npz` (the reference's initial parameters, tokens, W). The rank
writes what it holds to `OUT_DIR/rank{RANK}.npz`. Each FAULT named reruns
the case with one fault put in by this script, never by the package, and
writes that run's results under `fault/<FAULT>/`:

* `dropped_round` — the gossip schedule without its last round;
* `no_model_reduce` — the `model` group's gradient sum skipped;
* `wrong_rows` — rank 0 given the next agent's (or rank's) rows;
* `naive_uz` — Mamba's split `in_proj` used as the `[u | z]` it is not;
* `own_wo_partial` — rank 0 keeps its own partial sum after `wo` (it
  still joins the all-reduce, so the other ranks do not wait forever);
* `ep_wrong_rows` — rank 0 sends each expert owner another owner's block
  of its dispatch buffer (the all-to-all is still joined);
* `fsdp_own_part` — FSDP's backward keeps the rank's own part of the
  gradient without the sum over the "data" ranks;
* `per_rank_me` — the load-balance loss's top-1 share of tokens taken
  over the rank's own rows (the mean over the ranks left out).
"""

import dataclasses
import datetime
import os
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed.nn  # noqa: E402

from repro_torch.configs import base  # noqa: E402
from repro_torch.configs import gemma2_2b, jamba_1_5_large_398b  # noqa: E402
from repro_torch.configs import llava_next_34b, mixtral_8x7b  # noqa: E402
from repro_torch.configs.qwen2_0_5b import SMOKE_CONFIG as CFG  # noqa: E402
from repro_torch.core import dpsgd, gossip  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, sharding, train  # noqa: E402
from repro_torch.models import attention, convert, model, moe  # noqa: E402
from repro_torch.models import sharding_hints as sh  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

STEPS = 3
DECODE_STEPS = 4
MESHES = {
    "gossip": ((2, 2, 2), ("pod", "data", "model")),
    "train_data": ((4, 1), ("data", "model")),
    "train_data_dp": ((4, 2), ("data", "model")),
    "serve": ((4, 1), ("data", "model")),
    "world1": ((1, 1), ("data", "model")),
    "tp_train": ((4, 2), ("data", "model")),
    "tp_serve": ((1, 4), ("data", "model")),
    "tp_units": ((1, 2), ("data", "model")),
    "train_data_dp_moe": ((4, 2), ("data", "model")),
    "pod_train": ((2, 2, 2), ("pod", "data", "model")),
    "pod_serve": ((2, 2), ("data", "model")),
    "pod_units": ((2, 1), ("data", "model")),
}
TRAIN_MODES = {  # case -> [(mode name, gossip asked, W key)]
    "train_data": [("sparse", "sparse", "w_ring"), ("dense", "dense", "w_ring"),
                   ("allreduce", "allreduce", "w_j")],
    "train_data_dp": [("sparse", "sparse", "w_ring")],
    "train_data_dp_moe": [("sparse", "sparse", "w_ring")],
}
TRAIN_SHAPES = {"train_data": ("train_data", 16, 8, "train"),
                "train_data_dp": ("train_data_dp", 16, 16, "train"),
                "train_data_dp_moe": ("train_data_dp_moe", 16, 16, "train")}
TRAIN_CFGS = {"train_data": CFG, "train_data_dp": CFG,
              "train_data_dp_moe": mixtral_8x7b.SMOKE_CONFIG}
TRAIN_AUX = {"train_data_dp_moe": 1.0}   # the load-balance loss's weight
SERVE_BATCHES = (4, 2)   # 4 splits over "data", 2 does not
SERVE_PROMPT, SERVE_MAX_LEN = 8, 8 + DECODE_STEPS   # the last fed token fills it
TP_CFGS = {"qwen2": CFG, "mixtral": mixtral_8x7b.SMOKE_CONFIG,
           "jamba": jamba_1_5_large_398b.SMOKE_CONFIG,
           "gemma2": gemma2_2b.SMOKE_CONFIG}
TP_TRAIN_ARCHS = ("qwen2", "mixtral", "jamba")
TP_TRAIN_SHAPE = ("tp", 16, 8)       # name, seq_len, global batch (4 agents)
TP_SERVE_RUNS = ("qwen2:1:4", "gemma2:2:2", "mixtral:2:2")  # arch:data:model
TP_SERVE_BATCH = 2                   # splits over "data" at (2, 2)
POD_CFGS = {"mixtral": mixtral_8x7b.SMOKE_CONFIG,
            "jamba": jamba_1_5_large_398b.SMOKE_CONFIG,
            "llava": llava_next_34b.SMOKE_CONFIG}
# arch:global batch — 2 agents x 2 microbatches of 2 rows (split over
# "data") or of 1 row (every data rank holds it)
POD_TRAIN_RUNS = ("mixtral:8", "jamba:8", "llava:8", "mixtral:4")
POD_TRAIN_SEQ = 16
POD_AUX = 1.0                        # the load-balance loss's weight
POD_SERVE_RUNS = ("mixtral:2", "mixtral:1", "jamba:2", "jamba:1")  # arch:B
TWO_D_PARAMS = 10**12   # parameter_count reported, so 2-D is picked


def nest(flat: dict) -> dict:
    """``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def section(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in inputs.items()
            if k.startswith(prefix)}


def drop_last_round(schedule):
    return dataclasses.replace(schedule, rounds=schedule.rounds[:-1],
                               weights=schedule.weights[:-1])


def naive_uz(real_local):
    """``ssm._mamba_local`` with the rank's contiguous columns of
    ``in_proj`` taken as its ``[u | z]`` (after the real gather, so the
    ranks' collectives stay matched)."""
    def local(params, x, spec):
        got, x, partial = real_local(params, x, spec)
        if sh.tp() is not None:
            got = {**got, "in_proj": params["in_proj"]}
        return got, x, partial
    return local


def own_wo_partial(real):
    """``models.layers`` as attention sees it, with ``wo``'s rank-partial
    product kept as it is: the all-reduce is still joined (so the other
    ranks do not wait forever) and its sum dropped."""
    def keep_own(params, x, compute_dtype, partial):
        y = real.row_split_apply(params, x, compute_dtype, False)
        if partial:
            sh.reduce_from_tp(y)
        return y

    faulty = {k: getattr(real, k) for k in dir(real) if not k.startswith("__")}
    faulty["row_split_apply"] = keep_own
    return types.SimpleNamespace(**faulty)


def wrong_coords(mesh, coords, axes):
    """Rank 0's coordinates moved to the next index over ``axes``."""
    if torch.distributed.get_rank() != 0:
        return coords
    sizes = mesh_lib.axis_sizes(mesh)
    a = axes[-1]
    return {**coords, a: (coords[a] + 1) % sizes[a]}


def run_gossip(mesh, inputs, out, key, fault):
    coords = mesh_lib.coordinate(mesh)
    spec = {"a": sharding.P(("pod", "data"), None, "model")}
    local = sharding.shard_tree({"a": torch.from_numpy(inputs["gossip/x"])},
                                spec, mesh)
    for name in ("w_opt", "w_skew"):
        schedule = gossip.build_schedule(inputs[f"gossip/{name}"])
        if fault == "dropped_round":
            schedule = drop_last_round(schedule)
        mixed = gossip.mix_sparse_p2p(local, schedule, mesh, ("pod", "data"))
        out[f"{key}{name}"] = mixed["a"].numpy()
        if fault is None:
            whole = sharding.gather_tree(mixed, spec, mesh)
            out[f"{key}{name}/gathered"] = whole["a"].numpy()
    out[f"{key}coords"] = np.asarray(
        [coords[a] for a in mesh.mesh_dim_names])


def run_train(case, mesh, inputs, out, key, fault):
    coords = mesh_lib.coordinate(mesh)
    cfg = TRAIN_CFGS[case]
    agent0 = nest(section(inputs, "init_moe/" if cfg is not CFG
                          else "init/"))
    shape = base.ShapeConfig(*TRAIN_SHAPES[case])
    layout = "data" if case == "train_data" else "data_dp"
    for name, asked, w_key in TRAIN_MODES[case]:
        tcfg = base.TrainConfig(agent_layout=layout, gossip=asked,
                                microbatch=2, learning_rate=0.05,
                                moe_aux_weight=TRAIN_AUX.get(case, 1e-2))
        art = train.build_train_artifacts(
            cfg, tcfg, shape, mesh, inputs[w_key], device="cpu")
        params = dpsgd.replicate_for_agents(
            convert.params_from_jax(agent0, cfg, "cpu"), 1)
        state = {"params": params, "opt": sgd.init(params), "step": 0}
        batch_coords = coords
        if fault == "wrong_rows":
            batch_coords = wrong_coords(mesh, coords, ("data",))
        losses = []
        for k in range(STEPS):
            tokens = inputs[f"tokens/{case}/{k}"]
            local = sharding.shard_tree({"tokens": tokens}, art.batch_specs,
                                        mesh, batch_coords)
            state, met = art.step_fn(state, local)
            losses.append(float(met["loss"]))
        out[f"{key}{name}/resolved"] = np.asarray(art.gossip)
        out[f"{key}{name}/losses"] = np.asarray(losses)
        for path, leaf in tree_paths(convert.params_to_jax(state["params"])):
            out[f"{key}{name}/params/{path}"] = leaf
        for path, leaf in tree_paths(
                convert.params_to_jax(state["opt"]["momentum"])):
            out[f"{key}{name}/momentum/{path}"] = leaf
    out[f"{key}agent"] = np.asarray(mesh_lib.agent_index(mesh, ("data",)))
    if fault is None and case == "train_data_dp":
        # what the parent refused as unported now builds: the pod layout;
        # serving's 2-D TP on a (2, 4) mesh (Mixtral-8x7B's weights are
        # over 8 GB a model rank, so its rule splits them over "data"
        # too); a spec naming one axis twice is refused
        tcfg = base.TrainConfig(agent_layout="pod", gossip="sparse",
                                microbatch=2)
        pod = train.build_train_artifacts(CFG, tcfg, shape, mesh, None,
                                          device="cpu")
        wide = mesh_lib.init_mesh((2, 4), ("data", "model"), "cpu")
        served = serve.build_serve_artifacts(
            mixtral_8x7b.CONFIG, base.ShapeConfig("s", 12, 4, "prefill"),
            "cpu", wide)
        built = [_built(pod.param_specs, mesh),
                 _built(served.param_specs, wide)]
        tcfg = base.TrainConfig(agent_layout="data", gossip="sparse",
                                microbatch=2)
        art = train.build_train_artifacts(CFG, tcfg, shape, mesh,
                                          inputs["w_ring"], device="cpu")
        specs = dict(art.param_specs)
        specs["final_norm"] = {"scale": sharding.P("data", "data")}
        leaves = dict(art.state_shapes["params"])
        built.append(_refused(lambda: sharding.shard_tree(
            leaves, specs, mesh)))
        out["unported_raise"] = np.asarray(built)


def _built(specs, mesh) -> str:
    """What a build's specs split over "data": 'built, N leaves over
    data'."""
    n = sum(sharding.split_over(s, mesh, ("data",))
            for _, s in tree_paths(specs))
    return f"built, {n} leaves over data"


def _refused(fn) -> str:
    """The message of the ``ValueError`` that ``fn`` raises, or '' when
    it returns."""
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


def run_serve(mesh, inputs, out, key, fault):
    coords = mesh_lib.coordinate(mesh)
    params = convert.params_from_jax(nest(section(inputs, "init/")), CFG, "cpu")
    for b in SERVE_BATCHES:
        tokens = inputs[f"serve/tokens/{b}"]
        pre = serve.build_serve_artifacts(
            CFG, base.ShapeConfig("serve", SERVE_MAX_LEN, b, "prefill"),
            "cpu", mesh)
        dec = serve.build_serve_artifacts(
            CFG, base.ShapeConfig("serve", SERVE_MAX_LEN, b, "decode"),
            "cpu", mesh)
        use = coords
        if fault == "wrong_rows":
            use = wrong_coords(mesh, coords, ("data",))
        prompt = sharding.shard_tree(
            {"tokens": torch.from_numpy(tokens[:, :SERVE_PROMPT])},
            pre.input_specs, mesh, use)
        logits, caches = pre.prefill_fn(params, prompt)
        steps = [logits.numpy()]
        for t in range(DECODE_STEPS):
            nxt = torch.from_numpy(
                tokens[:, SERVE_PROMPT + t:SERVE_PROMPT + t + 1])
            logits, caches = dec.step_fn(
                params, caches, sharding.shard_tree(nxt, dec.input_specs,
                                                    mesh, use))
            steps.append(logits.numpy())
        out[f"{key}{b}/logits"] = np.stack(steps)
        out[f"{key}{b}/split"] = np.asarray(pre.input_specs["tokens"][0]
                                            is not None)


def run_tp_train(mesh, inputs, out, key, fault):
    """3 steps of the ``data`` layout at (4, 2) for each arch: the whole
    tree gathered back (``gather_tree``), the leaves left whole by the
    rule as this rank holds them, the expert ids of the first step."""
    for arch in TP_TRAIN_ARCHS:
        if fault == "naive_uz" and arch != "jamba":
            continue
        cfg = TP_CFGS[arch]
        tcfg = base.TrainConfig(agent_layout="data", gossip="sparse",
                                microbatch=2, learning_rate=0.05)
        art = train.build_train_artifacts(
            cfg, tcfg, base.ShapeConfig(*TP_TRAIN_SHAPE, "train"), mesh,
            inputs["w_ring"], device="cpu")
        whole = convert.params_from_jax(
            nest(section(inputs, f"init/{arch}/")), cfg, "cpu")
        stacked = dpsgd.replicate_for_agents(whole, art.num_agents)
        params = tree_map(lambda p: p.clone(), sharding.shard_tree(
            stacked, art.param_specs, mesh))
        if fault is None:
            again = sharding.gather_tree(params, art.param_specs, mesh)
            for path, leaf in tree_paths(convert.params_to_jax(again)):
                out[f"{arch}/init_gathered/{path}"] = leaf
        state = {"params": params, "opt": sgd.init(params), "step": 0}
        experts, real_route = [], moe.route

        def spy(*args, **kwargs):
            got = real_route(*args, **kwargs)
            experts.append(got[3].reshape(-1).numpy().copy())
            return got

        losses = []
        for k in range(STEPS):
            moe.route = spy if k == 0 else real_route
            local = sharding.shard_tree(
                {"tokens": inputs[f"tokens/{arch}/{k}"]}, art.batch_specs,
                mesh)
            state, met = art.step_fn(state, local)
            losses.append(float(met["loss"]))
        moe.route = real_route
        out[f"{key}{arch}/resolved"] = np.asarray(art.gossip)
        out[f"{key}{arch}/losses"] = np.asarray(losses)
        for part, tree in (("params", state["params"]),
                           ("momentum", state["opt"]["momentum"])):
            whole = sharding.gather_tree(tree, art.param_specs, mesh)
            for path, leaf in tree_paths(convert.params_to_jax(whole)):
                out[f"{key}{arch}/{part}/{path}"] = leaf
        specs = dict(tree_paths(art.param_specs))
        for part, tree in (("params", state["params"]),
                           ("momentum", state["opt"]["momentum"])):
            for path, leaf in tree_paths(tree):
                if "model" not in [a for e in specs[path][1:]
                                   for a in sharding._axes_of(e)]:
                    out[f"{key}{arch}/replicated/{part}/{path}"] = \
                        leaf.numpy()
        out[f"{key}{arch}/experts"] = np.concatenate(
            experts) if experts else np.zeros(0, np.int64)
    out[f"{key}agent"] = np.asarray(mesh_lib.agent_index(mesh, ("data",)))


_TP_MESHES: dict = {}


def tp_serve_mesh(data: int, model_size: int):
    """The (data, model) ``DeviceMesh`` over the default group, made once."""
    if (data, model_size) not in _TP_MESHES:
        _TP_MESHES[(data, model_size)] = mesh_lib.init_mesh(
            (data, model_size), ("data", "model"), "cpu")
    return _TP_MESHES[(data, model_size)]


def run_tp_serve(mesh, inputs, out, key, fault):
    """A prefill and DECODE_STEPS decode steps of each ``TP_SERVE_RUNS``
    entry on its mesh, each rank on its rows and its part of the
    weights; the leaf gathers of the run."""
    for run in TP_SERVE_RUNS:
        if fault is not None and run != TP_SERVE_RUNS[0]:
            continue
        arch, data, model_size = run.split(":")
        dm = tp_serve_mesh(int(data), int(model_size))
        cfg = TP_CFGS[arch]
        arts = [serve.build_serve_artifacts(
            cfg, base.ShapeConfig("serve", SERVE_MAX_LEN, TP_SERVE_BATCH,
                                  kind), "cpu", dm)
            for kind in ("prefill", "decode")]
        whole = convert.params_from_jax(
            nest(section(inputs, f"init/{arch}/")), cfg, "cpu")
        params = sharding.shard_tree(whole, arts[0].param_specs, dm)
        tokens = torch.from_numpy(inputs[f"serve/tokens/{arch}"])
        prompt = sharding.shard_tree({"tokens": tokens[:, :SERVE_PROMPT]},
                                     arts[0].input_specs, dm)
        sh.reset_gather_count()
        logits, caches = arts[0].prefill_fn(params, prompt)
        steps = [logits.numpy()]
        for t in range(DECODE_STEPS):
            nxt = tokens[:, SERVE_PROMPT + t:SERVE_PROMPT + t + 1]
            logits, caches = arts[1].step_fn(
                params, caches,
                sharding.shard_tree(nxt, arts[1].input_specs, dm))
            steps.append(logits.numpy())
        out[f"{key}{run}/logits"] = np.stack(steps)
        coords = mesh_lib.coordinate(dm)
        out[f"{key}{run}/coords"] = np.asarray([coords["data"],
                                                 coords["model"]])
        out[f"{key}{run}/split"] = np.asarray(
            arts[0].input_specs["tokens"][0] is not None)
        names = sorted(sh._GATHERS)
        out[f"{key}{run}/gather_names"] = np.asarray(names, dtype=str)
        out[f"{key}{run}/gather_counts"] = np.asarray(
            [sh.gather_count(n) for n in names], np.int64)


def run_tp_units(mesh, inputs, out, key, fault):
    """The conjugate pair, a summing-backward control, the
    vocabulary-parallel cross-entropy and the MoE's routing at 2 ranks,
    each against the whole computation in this process."""
    gen = torch.Generator().manual_seed(0)
    x, w1, w2, c = (torch.randn(s, generator=gen)
                    for s in ((4, 8), (8, 16), (16, 8), (4, 8)))
    i = mesh_lib.coordinate(mesh)["model"]
    cols = slice(8 * i, 8 * (i + 1))

    def mlp(reduce, copy, w1_, w2_):
        xr, a, b = (t.clone().requires_grad_(True) for t in (x, w1_, w2_))
        y = reduce(torch.nn.functional.gelu(copy(xr) @ a) @ b)
        grads = torch.autograd.grad((y * c).sum(), (xr, a, b))
        return {"y": y.detach(), "grad_x": grads[0], "grad_w1": grads[1],
                "grad_w2": grads[2]}

    whole = mlp(lambda t: t, lambda t: t, w1, w2)
    whole["grad_w1"] = whole["grad_w1"][:, cols]
    whole["grad_w2"] = whole["grad_w2"][cols]
    group = mesh_lib.axis_group(mesh, ("model",))
    with sh.hints({"tp": ("model",)}, mesh):
        pair = mlp(sh.reduce_from_tp, sh.copy_to_tp, w1[:, cols], w2[cols])
        summing = mlp(
            lambda t: torch.distributed.nn.functional.all_reduce(
                t, group=group), sh.copy_to_tp, w1[:, cols], w2[cols])
    for name, got in (("whole", whole), ("pair", pair),
                      ("summing", summing)):
        for k, v in got.items():
            out[f"{name}/{k}"] = v.numpy()

    logits = torch.randn((2, 5, 12), generator=gen)
    labels = torch.randint(0, 12, (2, 5), generator=gen)
    vocab = slice(6 * i, 6 * (i + 1))
    lw = logits.clone().requires_grad_(True)
    nll = model._nll(lw, labels)
    out["ce_whole/nll"] = nll.detach().numpy()
    out["ce_whole/grad_logits"] = torch.autograd.grad(
        nll.sum(), lw)[0][..., vocab].numpy()
    with sh.hints({"tp": ("model",)}, mesh):
        ll = logits[..., vocab].clone().requires_grad_(True)
        nll = model._nll(ll, labels, partial=True)
        out["ce/nll"] = nll.detach().numpy()
        out["ce/grad_logits"] = torch.autograd.grad(nll.sum(), ll)[0].numpy()

    spec = moe.MoESpec(64, 128, 4, 2, capacity_factor=1.0)
    params = moe.init(gen, spec, torch.float32, "cpu")
    xs = torch.randn((2, 6, 64), generator=gen)
    ff = slice(64 * i, 64 * (i + 1))
    local = {"router": params["router"], "gate": params["gate"][..., ff],
             "up": params["up"][..., ff], "down": params["down"][:, ff]}
    out["moe_whole/y"] = moe.apply(params, xs, spec, torch.float32,
                                   with_aux=False)[0].numpy()
    experts, real_route = [], moe.route

    def spy(*args, **kwargs):
        got = real_route(*args, **kwargs)
        experts.append(got[3].reshape(-1).numpy().copy())
        return got

    moe.route = spy
    with sh.hints({"tp": ("model",)}, mesh):
        out["moe/y"] = moe.apply(local, xs, spec, torch.float32,
                                 with_aux=False)[0].numpy()
    moe.route = real_route
    out["moe/experts"] = np.concatenate(experts)


def _dp_counts() -> dict:
    return {n: sh.dp_count(n) for n in ("fsdp_gather", "ep_dispatch",
                                        "ep_combine")}


def run_pod_train(mesh, inputs, out, key, fault):
    """3 steps of the ``pod`` layout at (2, 2, 2) for each
    ``POD_TRAIN_RUNS`` entry (with a fault, smoke Mixtral's first run
    only): the whole trees gathered back, the data-parallel collectives
    of the first step."""
    for run in POD_TRAIN_RUNS:
        if fault is not None and run != POD_TRAIN_RUNS[0]:
            continue
        arch, gb = run.split(":")
        cfg = POD_CFGS[arch]
        tcfg = base.TrainConfig(agent_layout="pod", gossip="sparse",
                                microbatch=2, learning_rate=0.05,
                                moe_aux_weight=POD_AUX)
        art = train.build_train_artifacts(
            cfg, tcfg, base.ShapeConfig("pod", POD_TRAIN_SEQ, int(gb),
                                        "train"), mesh, inputs["w_pair"],
            device="cpu")
        whole = convert.params_from_jax(
            nest(section(inputs, f"init/{arch}/")), cfg, "cpu")
        stacked = dpsgd.replicate_for_agents(whole, art.num_agents)
        params = tree_map(lambda p: p.clone(), sharding.shard_tree(
            stacked, art.param_specs, mesh))
        state = {"params": params, "opt": sgd.init(params), "step": 0}
        losses = []
        for k in range(STEPS):
            batch = {"tokens": inputs[f"tokens/{run}/{k}"]}
            if f"patches/{run}/{k}" in inputs:
                batch["patch_embeds"] = inputs[f"patches/{run}/{k}"]
            sh.reset_dp_count()
            state, met = art.step_fn(
                state, sharding.shard_tree(batch, art.batch_specs, mesh))
            if k == 0:
                counts = _dp_counts()
            losses.append(float(met["loss"]))
        out[f"{key}{run}/resolved"] = np.asarray(art.gossip)
        out[f"{key}{run}/losses"] = np.asarray(losses)
        out[f"{key}{run}/split"] = np.asarray(
            art.batch_specs["tokens"][2] is not None)
        out[f"{key}{run}/dp_counts"] = np.asarray(
            [counts[n] for n in sorted(counts)])
        for part, tree in (("params", state["params"]),
                           ("momentum", state["opt"]["momentum"])):
            whole = sharding.gather_tree(tree, art.param_specs, mesh)
            for path, leaf in tree_paths(convert.params_to_jax(whole)):
                out[f"{key}{run}/{part}/{path}"] = leaf


def run_pod_serve(mesh, inputs, out, key, fault):
    """A prefill and DECODE_STEPS decode steps of each ``POD_SERVE_RUNS``
    entry at (2, 2) with ``parameter_count`` reporting TWO_D_PARAMS, so
    the rule splits the weights over "data" too (with a fault, the first
    run only)."""
    real_count = model.parameter_count
    model.parameter_count = lambda cfg, params=None: TWO_D_PARAMS
    for run in POD_SERVE_RUNS:
        if fault is not None and run != POD_SERVE_RUNS[0]:
            continue
        arch, b = run.split(":")
        cfg = POD_CFGS[arch]
        arts = [serve.build_serve_artifacts(
            cfg, base.ShapeConfig("serve", SERVE_MAX_LEN, int(b), kind),
            "cpu", mesh) for kind in ("prefill", "decode")]
        whole = convert.params_from_jax(
            nest(section(inputs, f"init/{arch}/")), cfg, "cpu")
        params = sharding.shard_tree(whole, arts[0].param_specs, mesh)
        tokens = torch.from_numpy(inputs[f"serve/tokens/{run}"])
        prompt = sharding.shard_tree({"tokens": tokens[:, :SERVE_PROMPT]},
                                     arts[0].input_specs, mesh)
        sh.reset_dp_count()
        logits, caches = arts[0].prefill_fn(params, prompt)
        steps = [logits.numpy()]
        for t in range(DECODE_STEPS):
            nxt = tokens[:, SERVE_PROMPT + t:SERVE_PROMPT + t + 1]
            logits, caches = arts[1].step_fn(
                params, caches,
                sharding.shard_tree(nxt, arts[1].input_specs, mesh))
            steps.append(logits.numpy())
        counts = _dp_counts()
        out[f"{key}{run}/logits"] = np.stack(steps)
        coords = mesh_lib.coordinate(mesh)
        out[f"{key}{run}/coords"] = np.asarray([coords["data"],
                                                 coords["model"]])
        out[f"{key}{run}/split"] = np.asarray(
            arts[0].input_specs["tokens"][0] is not None)
        out[f"{key}{run}/dp_counts"] = np.asarray(
            [counts[n] for n in sorted(counts)])
        out[f"{key}{run}/over_data"] = np.asarray(sum(
            sharding.split_over(spec, mesh, ("data",))
            for _, spec in tree_paths(arts[0].param_specs)))
    model.parameter_count = real_count


def run_pod_units(mesh, inputs, out, key, fault):
    """At 2 ranks over "data", each against the whole computation in this
    process: FSDP's gather (its backward a reduce-scatter), EP's
    dispatch / combine pair, and the load-balance loss with the router's
    gradient over split rows."""
    i = mesh_lib.coordinate(mesh)["data"]
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn((4, 6), generator=gen), torch.randn((6, 5),
                                                             generator=gen)
    c = torch.randn((2, 4, 5), generator=gen)       # each rank's upstream
    xw = x.clone().requires_grad_(True)
    y = xw @ w
    whole = torch.autograd.grad((y * c[0]).sum() + (y * c[1]).sum(), xw)[0]
    out["fsdp_whole/grad"] = whole[2 * i:2 * (i + 1)].numpy()
    role_axes = {"batch": ("data",), "fsdp": ("data",), "ep": ("data",)}
    with sh.hints(role_axes, mesh):
        xp = x[2 * i:2 * (i + 1)].clone().requires_grad_(True)
        y = sh.gather_from_fsdp(xp, 0) @ w
        out["fsdp/y"] = y.detach().numpy()
        out["fsdp/grad"] = torch.autograd.grad((y * c[i]).sum(), xp)[0] \
            .numpy()
    out["fsdp_whole/y"] = (x @ w).numpy()

    # EP: 4 experts, 2 a rank; each rank's buffer [b 2, E 4, C 3, D 5]
    xin = torch.randn((2, 2, 4, 3, 5), generator=gen)     # [rank, ...]
    we = torch.randn((4, 5, 5), generator=gen)
    ce = torch.randn((2, 2, 4, 3, 5), generator=gen)
    xa = xin.clone().requires_grad_(True)
    wa = we.clone().requires_grad_(True)
    ya = torch.einsum("rbecd,edf->rbecf", xa, wa)
    gx, gw = torch.autograd.grad((ya * ce).sum(), (xa, wa))
    out["ep_whole/y"] = ya[i].detach().numpy()
    out["ep_whole/grad_x"] = gx[i].numpy()
    out["ep_whole/grad_w"] = gw[2 * i:2 * (i + 1)].numpy()
    with sh.hints(role_axes, mesh):
        xr = xin[i].clone().requires_grad_(True)
        wr = we[2 * i:2 * (i + 1)].clone().requires_grad_(True)
        owned = sh.ep_dispatch(xr)                       # [2·2, 2, 3, 5]
        yr = sh.ep_combine(torch.einsum("becd,edf->becf", owned, wr))
        gx, gw = torch.autograd.grad((yr * ce[i]).sum(), (xr, wr))
    out["ep/y"] = yr.detach().numpy()
    out["ep/grad_x"] = gx.numpy()
    out["ep/grad_w"] = gw.numpy()

    # the load-balance loss over rows split in two, and the router's
    # gradient (each rank's loss weighted 1/2, the gradients summed)
    spec = moe.MoESpec(16, 32, 4, 2, capacity_factor=8.0)
    params = moe.init(gen, spec, torch.float32, "cpu")
    xs = torch.randn((4, 6, 16), generator=gen)
    router = params["router"]["kernel"]

    def balance(rows, hinted):
        r = router.clone().requires_grad_(True)
        p = {**params, "router": {"kernel": r}}
        if hinted:
            with sh.hints({"batch": ("data",)}, mesh):
                aux = moe.apply(p, rows, spec, torch.float32)[1]
        else:
            aux = moe.apply(p, rows, spec, torch.float32)[1]
        lb = aux["load_balance_loss"]
        return lb.detach(), torch.autograd.grad(lb, r)[0]

    lb, g = balance(xs, False)
    out["balance_whole/loss"], out["balance_whole/grad"] = lb.numpy(), \
        g.numpy()
    for name in ("balance", "fault/per_rank_me/balance"):
        real = sh.batch_mean
        if name.startswith("fault"):
            sh.batch_mean = lambda t: t
        lb, g = balance(xs[2 * i:2 * (i + 1)], True)
        sh.batch_mean = real
        group = mesh_lib.axis_group(mesh, ("data",))
        mesh_lib.group_all_reduce(lb, group)
        mesh_lib.group_all_reduce(g, group)
        out[f"{name}/loss"], out[f"{name}/grad"] = (lb / 2).numpy(), \
            (g / 2).numpy()


def ep_wrong_rows(real_exchange):
    """``sharding_hints._exchange`` with rank 0's dispatch parts sent to
    the owners in reverse order (the all-to-all still joined)."""
    def exchange(x, split, cat, ctx):
        if torch.distributed.get_rank() == 0 and split == 1:
            x = torch.cat(list(x.chunk(ctx.size, dim=split))[::-1],
                          dim=split)
        return real_exchange(x, split, cat, ctx)
    return exchange


def fsdp_own_part(fctx, grad):
    """FSDP's backward cut to the rank's own part, unsummed."""
    n = grad.shape[fctx.dim] // fctx.dp.size
    return grad.narrow(fctx.dim, fctx.dp.index * n, n).contiguous(), None, \
        None


def run_world1(mesh, inputs, out, key, fault):
    """Three ``data_dp`` steps and a prefill + decode steps on the (1, 1)
    mesh and on the one-card path from the same state: equal bitwise?"""
    agent0 = nest(section(inputs, "init/"))
    shape = base.ShapeConfig(*TRAIN_SHAPES["train_data_dp"])
    tcfg = base.TrainConfig(agent_layout="data_dp", microbatch=2,
                            learning_rate=0.05)
    states, losses = {}, {}
    for name, m in (("mesh", mesh), ("one_card", mesh_lib.make_test_mesh(
            (1, 1)))):
        art = train.build_train_artifacts(
            CFG, tcfg, dataclasses.replace(shape, global_batch=4), m,
            device="cpu")
        params = dpsgd.replicate_for_agents(
            convert.params_from_jax(agent0, CFG, "cpu"), 1)
        state = {"params": params, "opt": sgd.init(params), "step": 0}
        losses[name] = []
        for k in range(STEPS):
            batch = {"tokens": inputs[f"tokens/train_data_dp/{k}"][:1]}
            if name == "mesh":
                batch = sharding.shard_tree(batch, art.batch_specs, mesh)
            state, met = art.step_fn(state, batch)
            losses[name].append(float(met["loss"]))
        states[name] = state
    out[f"{key}train_bitwise"] = np.asarray(
        losses["mesh"] == losses["one_card"] and all(
            torch.equal(a, b) for part in ("params", "opt")
            for a, b in zip(tree_leaves(states["mesh"][part]),
                            tree_leaves(states["one_card"][part]))))
    params = states["mesh"]["params"]
    flat = gossip.mix_sparse_flat(params, gossip.build_schedule(np.eye(1)),
                                  mesh, ("data",))
    out[f"{key}flat_identity"] = np.asarray(all(
        torch.equal(a, b) for a, b in zip(tree_leaves(flat),
                                          tree_leaves(params))))
    served = {}
    tokens = torch.from_numpy(inputs["serve/tokens/4"])
    weights = convert.params_from_jax(agent0, CFG, "cpu")
    for name, m in (("mesh", mesh), ("one_card", None)):
        arts = [serve.build_serve_artifacts(
            CFG, base.ShapeConfig("serve", SERVE_MAX_LEN, 4, kind), "cpu", m)
            for kind in ("prefill", "decode")]
        prompt = {"tokens": tokens[:, :SERVE_PROMPT]}
        if m is not None:
            prompt = sharding.shard_tree(prompt, arts[0].input_specs, mesh)
        logits, caches = arts[0].prefill_fn(weights, prompt)
        got = [logits]
        for t in range(DECODE_STEPS):
            logits, caches = arts[1].step_fn(
                weights, caches,
                tokens[:, SERVE_PROMPT + t:SERVE_PROMPT + t + 1])
            got.append(logits)
        served[name] = got
    out[f"{key}serve_bitwise"] = np.asarray(all(
        torch.equal(a, b) for a, b in zip(served["mesh"],
                                          served["one_card"])))


def main(argv):
    case, rank, world, init_method, inputs_path, out_dir, *faults = argv
    torch.set_num_threads(1)
    shape, axes = MESHES[case]
    mesh = mesh_lib.init_mesh(
        shape, axes, "cpu", init_method=init_method, rank=int(rank),
        world_size=int(world), timeout=datetime.timedelta(seconds=300))
    with np.load(inputs_path) as data:
        inputs = dict(data)
    out: dict = {}
    real_reduce, real_schedule = train._reduce_gradients, gossip.build_schedule
    real_local, real_layers = ssm._mamba_local, attention.layers
    real_exchange, real_mean = sh._exchange, sh.batch_mean
    real_backward = sh._GatherFromFSDP.backward
    for fault in [None, *faults]:
        key = "" if fault is None else f"fault/{fault}/"
        train._reduce_gradients, gossip.build_schedule = (
            real_reduce, real_schedule)
        ssm._mamba_local, attention.layers = real_local, real_layers
        sh._exchange, sh.batch_mean = real_exchange, real_mean
        sh._GatherFromFSDP.backward = real_backward
        if fault == "ep_wrong_rows":
            sh._exchange = ep_wrong_rows(real_exchange)
        if fault == "fsdp_own_part":
            sh._GatherFromFSDP.backward = staticmethod(fsdp_own_part)
        if fault == "per_rank_me":
            sh.batch_mean = lambda t: t
        if fault == "dropped_round":
            gossip.build_schedule = (
                lambda w, atol=1e-12: drop_last_round(real_schedule(w, atol)))
        if fault == "no_model_reduce":
            train._reduce_gradients = lambda grads, group: None
        if fault == "naive_uz":
            ssm._mamba_local = naive_uz(real_local)
        if fault == "own_wo_partial" and int(rank) == 0:
            attention.layers = own_wo_partial(real_layers)
        if case == "gossip":
            run_gossip(mesh, inputs, out, key, fault)
        elif case == "world1":
            run_world1(mesh, inputs, out, key, fault)
        elif case == "serve":
            run_serve(mesh, inputs, out, key, fault)
        elif case == "tp_train":
            run_tp_train(mesh, inputs, out, key, fault)
        elif case == "tp_serve":
            run_tp_serve(mesh, inputs, out, key, fault)
        elif case == "tp_units":
            run_tp_units(mesh, inputs, out, key, fault)
        elif case == "pod_train":
            run_pod_train(mesh, inputs, out, key, fault)
        elif case == "pod_serve":
            run_pod_serve(mesh, inputs, out, key, fault)
        elif case == "pod_units":
            run_pod_units(mesh, inputs, out, key, fault)
        else:
            run_train(case, mesh, inputs, out, key, fault)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("RANK_OK")


if __name__ == "__main__":
    main(sys.argv[1:])
