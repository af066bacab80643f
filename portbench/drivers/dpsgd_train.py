"""Closed-loop D-PSGD training through the launcher's step.

Set-up builds ``launch.train.build_train_artifacts(...).step_fn`` for all
agents on one card, the parameters from the seed (made here, on the
device, in one draw), and the program's input pipeline (``data.
Prefetcher``) over this benchmark's token stream. It drives that one step
function through the mix's first ``steps_followed`` steps, which warm up
every shape and which the plain reference follows afterwards, and hands it
on to the window: steps back to back, each from ``step_fn`` to
``torch.cuda.synchronize()``, begun while ``--seconds`` have not run out.
With ``--trace 1``, ``profiled_steps`` more steps run under the profiler.
Then the program's state is freed and the reference runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import resource
import sys
import time

import numpy as np
import torch

from portbench import checks, devtrace
from portbench.reference import dpsgd as ref_dpsgd
from portbench.reference.common import Matmul, flatten, nest
from portbench.tokens import TokenStream

FAULTS = ("frozen", "half_batch", "no_gossip", "other_rows")


@dataclasses.dataclass
class Outcome:
    end_to_end: dict          # metric name → value
    reading: dict             # what the per-layer readers take
    numbers: dict             # the compared numbers
    where: dict               # where each number's worst case is
    attempted: int
    memory_peak_bytes: int
    trace: devtrace.Trace | None = None
    control: dict | None = None   # the float8 reference's numbers
    prog: dict | None = None      # the readings compared, each side's
    ref: dict | None = None


def make_params(shapes: dict, seed: int, device, dtype, rule) -> dict:
    """One agent's parameters ``{path: leaf}`` from ``seed``: one normal
    draw N on ``device``, cut into leaves, each ``offset + std·N`` by the
    architecture's ``rule(path, shape) -> (offset, std)`` (an offset may
    be a list along the leaf's last axis)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for path, shape in shapes.items():
        n = draw[at:at + math.prod(shape)].view(shape)
        at += n.numel()
        offset, std = rule(path, shape)
        leaf = n * std
        if not isinstance(offset, (int, float)) or offset != 0:
            leaf = torch.as_tensor(offset, dtype=n.dtype, device=device) + leaf
        out[path] = leaf.to(dtype)
    del draw
    return out


def _norms(tree: dict, minus: dict | None = None) -> dict:
    """``{path: [A] norms}`` of a stacked tree (less ``minus``'s one-agent
    leaves), each agent's leaf in float32."""
    out = {}
    for path, leaf in flatten(tree).items():
        rows = []
        for a in range(leaf.shape[0]):
            x = leaf[a].to(torch.float32)
            if minus is not None:
                x = x - minus[path].to(torch.float32)
            rows.append(float(torch.linalg.vector_norm(x)))
        out[path] = np.array(rows)
    return out


def _log(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@contextlib.contextmanager
def _planted(fault: str | None):
    """The program with ``fault`` planted in its gossip (for the checks'
    calibration and tests; a benchmark run plants nothing)."""
    if fault != "no_gossip":
        yield
        return
    from repro_torch.core import gossip
    original = gossip.mix_sparse
    gossip.mix_sparse = lambda params, idx, weights: params
    try:
        yield
    finally:
        gossip.mix_sparse = original


@contextlib.contextmanager
def _losses_recorded(into: list):
    """Each value the program's ``models.model.loss`` returns, appended to
    ``into`` in the order of the calls: one an agent's microbatch, the
    agents in turn, as ``launch/train.grads_fn`` makes them."""
    from repro_torch.models import model
    original = model.loss

    def loss(*args, **kwargs):
        out = original(*args, **kwargs)
        into.append(out[0].detach())
        return out

    model.loss = loss
    try:
        yield
    finally:
        model.loss = original


def _agent_losses(records: list, agents: int) -> list[float]:
    """One step's ``[A]`` losses, each the mean of its agent's microbatches."""
    if not records or len(records) % agents:
        raise RuntimeError(f"{len(records)} losses recorded for {agents} agents")
    per = torch.stack(records).to(torch.float32).reshape(agents, -1)
    return per.mean(dim=1).tolist()


def _faulty(step_fn, fault: str | None, rows: int):
    if fault == "other_rows":   # agent 0 trains on agent 1's rows
        def step(state, batch):
            return step_fn(state, {k: torch.cat([v[1:2], v[1:]])
                                   for k, v in batch.items()})
        return step
    if fault == "frozen":
        def step(state, batch):
            return state, step_fn(state, batch)[1]
        return step
    if fault == "half_batch":
        def step(state, batch):
            return step_fn(state, {k: v[:, :, :rows // 2]
                                   for k, v in batch.items()})
        return step
    return step_fn


def run(ctx) -> Outcome:
    from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.optim import sgd

    model, mix, dev = ctx.config["model"], ctx.traffic, ctx.device
    agents, rows, seq = mix["agents"], mix["rows"], mix["seq_len"]
    followed = mix["steps_followed"]
    if ctx.fault is not None and ctx.fault not in FAULTS:
        raise ValueError(f"unknown fault {ctx.fault!r}; known: {FAULTS}")
    marks = [("imports", time.perf_counter())]
    cfg = ModelConfig(**{**model, "block_pattern": tuple(model["block_pattern"])})
    tcfg = TrainConfig(**ctx.config["train"])
    shape = ShapeConfig(mix["name"], seq, agents * rows, "train")
    w = np.asarray(mix["mixing_matrix"], np.float64)
    art = train_lib.build_train_artifacts(
        cfg, tcfg, shape, mesh_lib.make_test_mesh((agents, 1)), w, device=dev)
    if art.gossip != mix["gossip"]:
        raise RuntimeError(f"gossip resolved to {art.gossip}, the mix "
                           f"asks for {mix['gossip']}")
    k, mb = art.batch_shapes["tokens"].shape[1:3]
    if k * mb != rows:
        raise RuntimeError(f"the launcher splits {rows} rows as {k} x {mb}")

    shapes = ctx.arch.param_shapes(model)
    want = {p: (agents, *s) for p, s in shapes.items()}
    got = {p: tuple(t.shape) for p, t in
           flatten(art.state_shapes["params"]).items()}
    if got != want:
        raise RuntimeError("the program's parameter tree is not the "
                           f"reference's: {sorted(set(got.items()) ^ set(want.items()))[:4]}")
    marks.append(("artifacts", time.perf_counter()))
    dtype = getattr(torch, model["param_dtype"])
    p0 = make_params(shapes, ctx.seed, dev, dtype,
                     lambda path, shape: ctx.arch.init_rule(path, shape, model))
    params = nest({p: v[None].expand(agents, *v.shape).clone()
                   for p, v in p0.items()})
    state = {"params": params, "opt": sgd.init(params), "step": 0}
    del params

    _sync(dev)
    marks.append(("weights", time.perf_counter()))
    stream = TokenStream(model["vocab_size"], agents, ctx.seed,
                         mix["num_topics"], mix["dirichlet_alpha"])
    feed = Prefetcher(lambda t: {"tokens": stream.stacked(t, k, mb, seq)},
                      device=dev, prefetch=2)
    step_fn = _faulty(art.step_fn, ctx.fault, mb)
    box = {"state": state}          # the only reference to the live state
    del state
    prog: dict = {"loss": []}
    with _planted(ctx.fault):
        try:
            for t in range(followed):
                records: list = []
                with _losses_recorded(records):
                    box["state"], _ = step_fn(box["state"], next(feed)[1])
                prog["loss"].append(_agent_losses(records, agents))
                marks.append((f"step {t}", time.perf_counter()))
                if t == 0:
                    prog["grad"] = _norms(box["state"]["opt"]["momentum"])
            prog["change"] = _norms(box["state"]["params"], p0)
            _sync(dev)
            setup_s = time.perf_counter() - ctx.t0
            setup_peak = _peak(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)

            step_s = []
            start = time.perf_counter()
            while time.perf_counter() - start < ctx.seconds:
                t0 = time.perf_counter()
                box["state"], _ = step_fn(box["state"], next(feed)[1])
                _sync(dev)
                step_s.append(time.perf_counter() - t0)
            window_s = time.perf_counter() - start
            window_peak = _peak(dev)

            traced = None
            if ctx.trace and dev.type == "cuda":
                traced = _profile(step_fn, box, feed, mix["profiled_steps"],
                                  dev)
        finally:
            feed.close()
    _log("set-up phases " + ", ".join(
        f"{name} {t - ctx.t0:.2f}" for name, t in marks))
    _log(f"set-up {setup_s:.3f} s; window {window_s:.3f} s, steps "
         f"{[round(x, 4) for x in step_s]}; peaks {setup_peak} / "
         f"{window_peak} B; traced {traced.wall_s if traced else 0:.3f} s")
    del box, art, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    batches = [torch.from_numpy(stream.stacked(t, k, mb, seq)).to(dev).reshape(
        agents, k * mb, seq + 1).to(torch.int64) for t in range(followed)]
    t_ref = time.perf_counter()
    ref = ref_dpsgd.follow(ctx.arch, model, p0, w, batches,
                           tcfg.learning_rate, tcfg.momentum)
    numbers, where = checks.gaps(prog, ref)
    _log(f"reference {time.perf_counter() - t_ref:.3f} s; losses "
         f"{prog['loss']} / {ref['loss']}")
    control = None
    if ctx.control:     # the reference in float8 in the program's place
        low = ref_dpsgd.follow(ctx.arch, model, p0, w, batches,
                               tcfg.learning_rate, tcfg.momentum,
                               Matmul(fp8=True))
        control = checks.gaps(low, ref)[0]
    tokens_per_step = agents * rows * seq
    return Outcome(
        end_to_end={
            "train_tokens_per_s": (tokens_per_step * len(step_s) / window_s
                                   if step_s else None),
            "peak_memory_gb": window_peak / 1e9,
            "setup_s": setup_s,
        },
        reading={"step_s": step_s, "window_s": window_s,
                 "tokens_per_step": tokens_per_step,
                 "flops_per_token": ctx.arch.flops_per_token(model, seq),
                 "param_shapes": shapes, "agents": agents, "rows": mb,
                 "seq_len": seq, "model": model,
                 "profiled_steps": mix["profiled_steps"]},
        numbers=numbers, where=where, attempted=len(step_s),
        memory_peak_bytes=max(setup_peak, window_peak), trace=traced,
        control=control, prog=prog, ref=ref)


def _profile(step_fn, box: dict, feed, steps: int, dev) -> devtrace.Trace:
    """``steps`` more steps of ``box["state"]`` under ``torch.profiler``
    (host and CUDA)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(dev)
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function(devtrace.STEP_SPAN):
                box["state"], _ = step_fn(box["state"], next(feed)[1])
        _sync(dev)
    return devtrace.reduce(prof, time.perf_counter() - start)
