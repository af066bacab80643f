"""Dry run of the production meshes: one rank of every (arch × shape ×
mesh) cell traced on fake tensors over a fake process group.

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell on 256 or 512 forced host devices. Here one process
stands for rank 0 of the 16 × 16 (``pod16x16``, 256 ranks) or 2 × 16 × 16
(``pod2x16x16``, 512 ranks) mesh:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod] [--device cpu] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Per cell it opens a fake process group of the mesh's size
(``launch.mesh.init_mesh(..., backend="fake")``: no data crosses, every
collective returns at once), builds the cell's artifacts on that
``DeviceMesh`` as the launcher does, gives rank 0 its state as empty
tensors of its local shapes under ``FakeTensorMode`` (no random draw: a
full-size tree is never materialised) and runs one training step, or one
prefill or decode step, reading none of its outputs. A training step
takes the rank's part of the batch as the launcher hands it
(``train.local_batch``): of a microbatch of mb rows over the batch role's
n ranks, mb / gcd(mb, n) rows — one row of 8 over 16 ranks at
``pod2x16x16``, where the reference's spec drops the split and each rank
would hold all 8. It records:

* ``memory`` — rank 0's peak live bytes (``StepCount``) by kind:
  ``parameters`` and ``optimizer_state`` (the state handed in),
  ``inputs`` (the batch, or the caches and the token), ``activations``
  (everything the step allocates outside autograd's backward — the
  gradient accumulators, the new state and the logits included) and
  ``temporaries`` (what autograd's backward allocates, each
  microbatch's parameter gradients included); the counterpart of
  ``compiled.memory_analysis()``;
* ``cost_flops`` — the aten FLOPs (``StepCount``, by
  ``torch.utils.flop_counter``'s formulas) plus the kernels' own
  (``kernels.ops.fake_flops``: a ctypes launch is invisible to the
  counter);
* ``collectives`` — bytes and calls by kind (``launch.mesh``'s count);
* ``launches`` — the kernel launches the step makes, by design: the
  wrappers' calls on fake tensors, counted apart from launches, none of
  which launched;
* ``roofline`` — ``roofline.analysis.report(...).to_dict()`` at the H100's
  peaks (``analysis.H100``): a model at datasheet peaks, not a measurement;
* ``trace_s`` — the seconds of the fake pass, in place of the reference's
  ``lower_s`` / ``compile_s``.

The reference's ``cost_bytes`` (XLA's "bytes accessed") has no
counterpart and is left out.

``device=None`` means CUDA: fake CUDA tensors, so attention, the gossip's
combine and the recurrent mixers' scans take their kernels' fake branch
(the kernel's outputs, what it saves for the backward included, the call
counted, nothing launched): a recurrent layer is one call, not a step a
token. ``device="cpu"`` (the
tests) uses fake CPU tensors, where attention takes its plain version:
``memory`` and ``cost_flops`` then include the plain version's score
matrices, and count no kernel launch. The card's figures are the ones
that count.

``run_cell`` opens the default group of its cell's mesh and destroys it
after, so the process must hold no other; ``main`` runs each cell in a
process of its own (``run_cell_process``, as many at once as the host has
CPUs), and a cell that traces past ``CELL_BUDGET_S`` seconds is recorded
as an ``error``. A fake group never runs a real step; ``real_pass``
runs the rank's step for real under the same fake group (seeded state,
values meaning nothing) to hold the fake pass's peak memory, launches
and collective bytes on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import compat
from repro_torch.configs.base import (
    ALL_SHAPES,
    ARCH_IDS,
    cell_is_supported,
    get_config,
    get_shape,
    get_train_config,
)
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import mixing_combine as mixing_mod
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.kernels import slstm_scan as slstm_mod
from repro_torch.launch import fabric, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import build_serve_artifacts
from repro_torch.launch.train import build_train_artifacts, local_batch
from repro_torch.models import model as M
from repro_torch.optim import sgd
from repro_torch.roofline import analysis as roofline
from repro_torch.runtime.design_service import _Caught
from repro_torch.tree import tree_leaves, tree_map

_DEVICE = torch.ops.prim.device.default
MEMORY_KINDS = ("parameters", "optimizer_state", "inputs", "activations",
                "temporaries")
# The fabric W is designed for: every link of the production mesh is one
# NDR NIC a GPU (analysis.H100's link rate), and the two pods of the
# 512-rank mesh hang off one non-blocking fat tree, so a cross-pod link
# runs at the same rate.
FABRIC_LINK_BW = roofline.H100.link_bytes_per_s
FABRIC_CROSS_POD_BW = roofline.H100.link_bytes_per_s
# Seconds a cell of the command line may trace before it is an error (a
# loop of ops over every token of a 32k prompt would run for hours on fake
# tensors).
CELL_BUDGET_S = 1200.0


class StepCount(TorchDispatchMode):
    """The live storages' bytes by kind and their peak, and the aten
    FLOPs, of what runs under it. The bytes: the tensors handed in by
    kind (``external``), then every storage an op creates —
    ``temporaries`` inside autograd's backward, ``activations`` outside
    it — until it is freed; ``peak`` is the largest total, ``at_peak``
    the kinds at that moment. The FLOPs: ``torch.utils.flop_counter``'s
    formula of each op that has one (``FlopCounterMode``'s table). Works
    on fake tensors (their storages have sizes and no data)."""

    def __init__(self, external: dict):
        super().__init__()
        self._live = WeakIdKeyDictionary()
        self.now = dict.fromkeys(MEMORY_KINDS, 0)
        self.peak = 0
        self.at_peak = dict(self.now)
        self.flops = 0
        for kind, tensors in external.items():
            for t in tensors:
                self._add(kind, t)

    def _add(self, kind: str, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        self._live[st] = (kind, n)
        self.now[kind] += n
        weakref.finalize(st, self._freed, kind, n)
        total = sum(self.now.values())
        if total > self.peak:
            self.peak = total
            self.at_peak = dict(self.now)

    def _freed(self, kind: str, n: int) -> None:
        self.now[kind] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:
            return func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            # a composite op (inference mode skips the autograd key that
            # decomposes them): run its parts here, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        kind = ("temporaries" if torch._C._current_graph_task_id() != -1
                else "activations")
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(kind, t)
        return out

    def memory(self) -> dict:
        return {**{k: int(v) for k, v in self.at_peak.items()},
                "peak": int(self.peak)}


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def open_mesh(multi_pod: bool, device=None):
    """rank 0 of the production mesh over a fake process group."""
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = int(np.prod(mesh.axis_sizes))
    return mesh_lib.init_mesh(mesh.axis_sizes, mesh.axis_names, device,
                              backend="fake", rank=0, world_size=chips)


def _empty_like_tree(tree, dev, fill=None):
    """Tensors of each leaf's shape and dtype on ``dev`` (zeros where
    ``fill`` is 0, else uninitialised): no draw."""
    def make(t):
        out = torch.empty(t.shape, dtype=t.dtype, device=dev)
        return out if fill is None else out.fill_(fill)
    return tree_map(make, tree)


@dataclasses.dataclass
class Cell:
    """One cell's artifacts on a rank: ``run(state)`` runs its step,
    ``make_state(seed)`` gives the state it takes — empty tensors of the
    rank's local shapes (``seed`` None) or ones drawn from ``seed``."""
    kind: str
    num_agents: int
    w: np.ndarray | None
    tcfg: object
    make_state: object
    run: object


def _draw(tree, seed: int, dev):
    """Each floating leaf N(0, 0.02²) from ``seed`` on ``dev`` (drawn in
    float32, cast), integer leaves 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen, device=dev,
                                dtype=torch.float32) * 0.02).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)
    return tree_map(leaf, tree)


def make_cell(cfg, shape, dm, device=None, tcfg=None,
              w: np.ndarray | None = None) -> Cell:
    """The step of ``shape`` (``tcfg`` and the mixing matrix ``w`` for a
    training shape) for the calling rank of ``dm``, as the launcher and
    the serving path build it; the state of the rank's local shapes."""
    dev = compat.resolve_device(device)
    if shape.kind == "train":
        art = build_train_artifacts(cfg, tcfg, shape, dm, w, device=dev)
        params = sharding.shard_tree(art.state_shapes["params"],
                                     art.param_specs, dm)
        batch = local_batch(art, art.batch_shapes, dm)

        def make_state(seed=None):
            p = (_empty_like_tree(params, dev) if seed is None
                 else _draw(params, seed, dev))
            return ({"params": p, "opt": sgd.init(p), "step": 0},
                    _empty_like_tree(batch, dev, fill=0))

        def run(state):
            st, b = state
            return art.step_fn(st, b)

        return Cell("train", art.num_agents, w, tcfg, make_state, run)

    art = build_serve_artifacts(cfg, shape, dev, dm)
    params = sharding.shard_tree(art.param_shapes, art.param_specs, dm)
    inputs = sharding.shard_tree(art.input_shapes, art.input_specs, dm)

    def make_state(seed=None):
        p = (_empty_like_tree(params, dev) if seed is None
             else _draw(params, seed, dev))
        x = _empty_like_tree(inputs, dev, fill=0)
        if shape.kind == "prefill":
            return p, x
        return p, x, art.init_caches(p, x.shape[0])

    def run(state):
        if shape.kind == "prefill":
            return art.prefill_fn(*state)
        p, x, caches = state
        return art.step_fn(p, caches, x)

    return Cell(shape.kind, 1, None, None, make_state, run)


def build_cell(arch: str, shape_name: str, multi_pod: bool, dm,
               gossip: str = "auto", device=None) -> Cell:
    """The cell's artifacts on ``dm`` (rank 0 of the production mesh), as
    the reference builds them: for training, m from the layout, κ =
    parameters × 2 / ``model``, and W designed on the fabric — on the
    host, leaving the card to the step."""
    cfg = get_config(arch)
    tcfg = get_train_config(arch)
    if gossip != "auto":
        tcfg = dataclasses.replace(tcfg, gossip=gossip)
    shape = get_shape(shape_name)
    w = None
    if shape.kind == "train":
        m = mesh_lib.num_agents(dm, tcfg.agent_layout)
        if m > 1:
            # κ = per-agent parameter bytes shipped per gossip exchange
            # (bf16 params / TP shards).
            kappa = M.parameter_count(cfg) * 2 / mesh_lib.axis_sizes(dm)[
                "model"]
            w, _ = fabric.design_mixing_matrix(
                m, pods=(2 if multi_pod else 1), kappa_bytes=kappa,
                link_bw=FABRIC_LINK_BW, cross_pod_bw=FABRIC_CROSS_POD_BW,
                device="cpu")
    return make_cell(cfg, shape, dm, device, tcfg, w)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel and design."""
    return {"mixing_sgd_combine": ops.launch_count("mixing_sgd_combine"),
            "flash_attention": flash_mod.launch_count_by_design(),
            "decode_attention": decode_mod.launch_count_by_design(),
            "selective_scan": scan_mod.launch_count_by_design(),
            "slstm_scan": slstm_mod.launch_count_by_design()}


def fake_call_counts() -> dict:
    """The kernel wrappers' calls on fake tensors since the last reset, in
    ``launch_counts``' form: the launches the step would make."""
    return {"mixing_sgd_combine": mixing_mod.fake_call_count(),
            "flash_attention": flash_mod.fake_calls_by_design(),
            "decode_attention": decode_mod.fake_calls_by_design(),
            "selective_scan": scan_mod.fake_calls_by_design(),
            "slstm_scan": slstm_mod.fake_calls_by_design()}


def _state_kinds(cell: Cell, state) -> dict:
    if cell.kind == "train":
        st, batch = state
        return {"parameters": tree_leaves(st["params"]),
                "optimizer_state": tree_leaves(st["opt"]),
                "inputs": tree_leaves(batch)}
    return {"parameters": tree_leaves(state[0]),
            "inputs": [t for part in state[1:] for t in tree_leaves(part)]}


def fake_pass(cell: Cell) -> dict:
    """One step of ``cell`` on fake tensors: its memory, FLOPs,
    collectives and launches, and the seconds it took."""
    ops.reset_fake_calls()
    mesh_lib.reset_collective_stats()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = cell.make_state()
        with StepCount(_state_kinds(cell, state)) as count:
            out = cell.run(state)
            del out, state
    trace_s = time.perf_counter() - t0
    kernel_flops = sum(ops.fake_flops(k) for k in ops.KERNELS)
    return {"trace_s": trace_s, "memory": count.memory(),
            "cost_flops": float(count.flops + kernel_flops),
            "kernel_flops": float(kernel_flops),
            "collectives": dataclasses.asdict(mesh_lib.collective_stats()),
            "launches": fake_call_counts()}


def real_pass(cell: Cell, seed: int = 0) -> dict:
    """The step run for real on the rank's device: the state drawn from
    ``seed`` (under a fake group its values mean nothing: no data
    crosses), its parameter bytes, its launches and collectives, and on
    the card its peak ``torch.cuda.max_memory_allocated()`` from the
    state on."""
    state = cell.make_state(seed)
    params = _state_kinds(cell, state)["parameters"]
    cuda = params[0].is_cuda
    param_bytes = sum(t.numel() * t.element_size() for t in params)
    del params
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    mesh_lib.reset_collective_stats()
    t0 = time.perf_counter()
    out = cell.run(state)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del out, state
    return {"seconds": seconds, "parameters": param_bytes,
            "peak": int(torch.cuda.max_memory_allocated()) if cuda else None,
            "collectives": dataclasses.asdict(mesh_lib.collective_stats()),
            "launches": launch_counts()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             gossip: str = "auto", device=None, verbose: bool = True) -> dict:
    """The cell's record (module docstring); opens the fake group of its
    mesh, which must be the process's first, and destroys it after."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = cell_is_supported(cfg, shape)
    name = mesh_name(multi_pod)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "skipped", "reason": reason}
    chips = 512 if multi_pod else 256
    record = {"arch": arch, "shape": shape_name, "mesh": name,
              "chips": chips}
    with _Caught(Exception) as caught:
        dm = open_mesh(multi_pod, device)
        cell = build_cell(arch, shape_name, multi_pod, dm, gossip, device)
        if cell.kind == "train":
            record["num_agents"] = cell.num_agents
            record["gossip_mode"] = cell.tcfg.gossip
        got = fake_pass(cell)
        edges = 0
        if cell.kind == "train" and cell.num_agents > 1:
            w_off = cell.w - np.diag(np.diag(cell.w))
            edges = int(np.count_nonzero(np.abs(w_off) > 1e-12))
        rep = roofline.report(
            arch=arch, shape=shape, cfg=cfg, mesh_name=name, chips=chips,
            collectives=mesh_lib.collective_stats(), peaks=roofline.H100,
            num_agents=cell.num_agents, remat=True,
            tcfg=cell.tcfg if cell.kind == "train" else None,
            mesh_shape=mesh_lib.axis_sizes(dm),
            gossip_directed_edges=edges)
        record.update(status="ok", **got, roofline=rep.to_dict())
        if verbose:
            print(f"[ok] {arch} × {shape_name} × {name}: trace "
                  f"{got['trace_s']:.1f}s dominant={rep.dominant} "
                  f"bound={rep.bound_s * 1e3:.2f}ms "
                  f"roofline={rep.roofline_fraction:.2%} "
                  f"coll={rep.collective_bytes_per_chip / 1e6:.0f}MB/chip "
                  f"peak={got['memory']['peak'] / 1e9:.1f}GB", flush=True)
    if caught.error is not None:
        e = caught.error
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = "".join(traceback.format_exception(e))[-6000:]
        if verbose:
            print(f"[ERR] {arch} × {shape_name} × {name}: {record['error']}",
                  flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return record


_CELL = (
    "import json, sys\n"
    "from repro_torch.launch import dryrun\n"
    "rec = dryrun.run_cell(*json.loads(sys.argv[1]))\n"
    "print('RECORD ' + json.dumps(rec), flush=True)\n"
)


def run_cell_process(arch: str, shape_name: str, multi_pod: bool,
                     gossip: str = "auto", device=None,
                     budget_s: float | None = None) -> dict:
    """``run_cell`` in a process of its own (one default group a process),
    killed past ``budget_s`` seconds: the cell is then an ``error``."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    args = json.dumps([arch, shape_name, multi_pod, gossip, device])
    proc = None
    with _Caught(subprocess.TimeoutExpired) as late:
        proc = subprocess.run([sys.executable, "-c", _CELL, args], env=env,
                              stdout=subprocess.PIPE, text=True,
                              timeout=budget_s)
    lines = [] if proc is None else [
        ln for ln in proc.stdout.splitlines() if ln.startswith("RECORD ")]
    for ln in (proc.stdout.splitlines() if proc is not None else []):
        if not ln.startswith("RECORD "):
            print(ln, flush=True)
    if lines:
        return json.loads(lines[-1][len("RECORD "):])
    error = (f"TimeoutError: the cell ran past {budget_s} s"
             if late.error is not None
             else f"the cell's process exited {proc.returncode}")
    print(f"[ERR] {arch} × {shape_name} × {mesh_name(multi_pod)}: {error}",
          flush=True)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
            "chips": 512 if multi_pod else 256, "status": "error",
            "error": error}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all archs × shapes")
    ap.add_argument("--gossip", default="auto",
                    choices=["auto", "sparse", "dense", "allreduce"])
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--device", default=None,
                    help="cpu for fake CPU tensors (default: CUDA)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = (
        [s.name for s in ALL_SHAPES]
        if (args.all or not args.shape)
        else [args.shape]
    )
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(arch, shape, mp) for mp in meshes for arch in archs
             for shape in shapes]
    # the longest traces first, so that every process is kept busy:
    # training, then prefill, long context, decode; the recurrent archs
    # first, then by depth
    rank = {"train_4k": 0, "prefill_32k": 1, "long_500k": 2,
            "decode_32k": 3}

    def cost(c):
        cfg = get_config(c[0])
        loops = any(k.startswith(("mamba", "slstm"))
                    for k in cfg.block_pattern)
        return rank[c[1]], not loops, -cfg.num_layers

    cells.sort(key=cost)
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        records = list(pool.map(
            lambda c: run_cell_process(*c, args.gossip, args.device,
                                       CELL_BUDGET_S), cells))
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        # de-dup on (arch, shape, mesh): new records win
        keys = {(r["arch"], r["shape"], r["mesh"]) for r in records}
        existing = [
            r for r in existing
            if (r["arch"], r["shape"], r["mesh"]) not in keys
        ]
        with open(args.out, "w") as f:
            json.dump(existing + records, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"cells: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
