"""One rank of the port's runs across ranks (gloo on the CPU), started by
`tests/test_torch_multirank.py` once per rank:

    python tests/_torch_rank.py CASE RANK WORLD INIT_METHOD INPUTS OUT_DIR [FAULT ...]

CASE is `gossip` (a (2, 2, 2) mesh), `train_data` (a (4, 1) mesh, the
`data` layout in the sparse, dense and allreduce modes), `train_data_dp`
(a (4, 2) mesh, `data_dp`/sparse), `serve` (a (4, 1) mesh) or `world1`
(a (1, 1) mesh: the mesh paths against the one-card paths, which is all
one card can run over NCCL). INPUTS is
the test's `npz` (the reference's initial parameters, tokens, W). The rank
writes what it holds to `OUT_DIR/rank{RANK}.npz`. Each FAULT named reruns
the case with one fault put in by this script, never by the package, and
writes that run's results under `fault/<FAULT>/`:

* `dropped_round` — the gossip schedule without its last round;
* `no_model_reduce` — the `model` group's gradient sum skipped;
* `wrong_rows` — rank 0 given the next agent's (or rank's) rows.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.qwen2_0_5b import SMOKE_CONFIG as CFG  # noqa: E402
from repro_torch.core import dpsgd, gossip  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, sharding, train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

STEPS = 3
DECODE_STEPS = 4
MESHES = {
    "gossip": ((2, 2, 2), ("pod", "data", "model")),
    "train_data": ((4, 1), ("data", "model")),
    "train_data_dp": ((4, 2), ("data", "model")),
    "serve": ((4, 1), ("data", "model")),
    "world1": ((1, 1), ("data", "model")),
}
TRAIN_MODES = {  # case -> [(mode name, gossip asked, W key)]
    "train_data": [("sparse", "sparse", "w_ring"), ("dense", "dense", "w_ring"),
                   ("allreduce", "allreduce", "w_j")],
    "train_data_dp": [("sparse", "sparse", "w_ring")],
}
TRAIN_SHAPES = {"train_data": ("train_data", 16, 8, "train"),
                "train_data_dp": ("train_data_dp", 16, 16, "train")}
SERVE_BATCHES = (4, 2)   # 4 splits over "data", 2 does not
SERVE_PROMPT, SERVE_MAX_LEN = 8, 8 + DECODE_STEPS   # the last fed token fills it


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
    agent0 = nest(section(inputs, "init/"))
    shape = base.ShapeConfig(*TRAIN_SHAPES[case])
    layout = "data" if case == "train_data" else "data_dp"
    for name, asked, w_key in TRAIN_MODES[case]:
        tcfg = base.TrainConfig(agent_layout=layout, gossip=asked,
                                microbatch=2, learning_rate=0.05)
        art = train.build_train_artifacts(
            CFG, tcfg, shape, mesh, inputs[w_key], device="cpu")
        params = dpsgd.replicate_for_agents(
            convert.params_from_jax(agent0, CFG, "cpu"), 1)
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
        refused = []
        for other, w in (("pod", None), ("data", inputs["w_ring"])):
            tcfg = base.TrainConfig(agent_layout=other, gossip="sparse",
                                    microbatch=2)
            refused.append(_raises(lambda: train.build_train_artifacts(
                CFG, tcfg, shape, mesh, w, device="cpu")))
        refused.append(_raises(lambda: serve.build_serve_artifacts(
            CFG, base.ShapeConfig("s", 12, 4, "prefill"), "cpu", mesh)))
        out["unported_raise"] = np.asarray(refused)


def _raises(fn) -> str:
    """The message of the ``NotImplementedError`` that ``fn`` raises, or
    '' when it returns."""
    try:
        fn()
    except NotImplementedError as err:
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
    for fault in [None, *faults]:
        key = "" if fault is None else f"fault/{fault}/"
        train._reduce_gradients, gossip.build_schedule = (
            real_reduce, real_schedule)
        if fault == "dropped_round":
            gossip.build_schedule = (
                lambda w, atol=1e-12: drop_last_round(real_schedule(w, atol)))
        if fault == "no_model_reduce":
            train._reduce_gradients = lambda grads, group: None
        if case == "gossip":
            run_gossip(mesh, inputs, out, key, fault)
        elif case == "world1":
            run_world1(mesh, inputs, out, key, fault)
        elif case == "serve":
            run_serve(mesh, inputs, out, key, fault)
        else:
            run_train(case, mesh, inputs, out, key, fault)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("RANK_OK")


if __name__ == "__main__":
    main(sys.argv[1:])
