#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N] [--steps N] [--seq N] [--profile]

Drives the port's main path — priced D-PSGD training of Qwen2-0.5B at its
full width and depth with 8 agents on one card — through the entry points
a user calls (``model.loss`` → ``make_dpsgd_step`` → ``train_priced``),
after building the hand-written kernel from ``src/repro_torch/kernels/
csrc`` with ``nvcc`` and holding it against its plain PyTorch version on
the card. Needs a CUDA device and ``nvcc``; there is no CPU path. Any
failed phase raises and the script exits non-zero.

Output: one JSON object per phase (``device``, ``build``,
``kernel_check``, ``small_reference``, ``train``), then the line
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives,
then ``{"kernels": [...]}`` (one entry per kernel: launches on the main
path, error against the plain version, time on the card beside its bound,
the plain version's time and one library call's), and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np
import torch

from repro_torch.configs import qwen2_0_5b
from repro_torch.core import dpsgd, gossip, mixing
from repro_torch.core.priced_training import StaticTau, train_priced
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.kernels import build, ops, ref
from repro_torch.models import model
from repro_torch.tree import tree_leaves, tree_map, tree_paths

# Published peaks of one H100 SXM (NVIDIA's data sheet): the roofline the
# kernel's bound is stated against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/mixing_combine.cu"
KERNEL_REPLACES = "src/repro/kernels/mixing_combine.py:38"

FP32_TOL = 1e-5   # the reference's own (tests/test_kernels.py)
BF16_TOL = 2e-2   # one bf16 rounding vs. the unfused form's two
# Kernel against its plain version in bf16 at the main path's shapes: both
# accumulate in float32 and round once, so they differ by at most one bf16
# ulp of the result (2^-7 of its value) where the two summation orders
# round to different neighbours; atol = BF16_ULP_ATOL x the data's scale
# covers results that cancel to near zero.
BF16_ULP_RTOL = 8e-3
BF16_ULP_ATOL = 1e-4

TIMING_REPS = 20

# Modelled network seconds per gossip round: a constant input of this
# slice (the routed tau of a design arrives with the network simulator).
TAU = 12.5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_cuda(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the device, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(got, want, rtol: float, atol: float) -> tuple[bool, float]:
    """Whether ``got`` is finite and within ``atol + rtol*|want|`` of
    ``want`` everywhere (in float32), and the largest absolute error."""
    g32, w32 = got.to(torch.float32), want.to(torch.float32)
    err = (g32 - w32).abs_()
    bad = err > w32.abs().mul_(rtol).add_(atol)
    max_err = float(err.max()) if err.numel() else 0.0
    agree = not bool(bad.any()) and bool(torch.isfinite(g32).all())
    return agree, max_err


def assert_close(got, want, tol: float, what: str, atol=None) -> float:
    """``|got - want| <= atol + tol*|want|`` in float32 (atol = tol unless
    given); returns the largest absolute error."""
    atol = tol if atol is None else atol
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}"
        )
    agree, max_err = compare(got, want, tol, atol)
    if not agree:
        raise AssertionError(
            f"{what}: kernel and plain version disagree beyond "
            f"rtol={tol} atol={atol} (max abs err {max_err})"
        )
    return max_err


def ring_matrix(m: int, alpha: float = 1.0 / 3.0) -> np.ndarray:
    links = [(i, (i + 1) % m) for i in range(m)]
    w = mixing.matrix_from_weights(m, links, [alpha] * len(links))
    mixing.validate_mixing(w)
    return w


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    emit(
        "device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi,
    )
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = build.build("mixing_combine", verbose=True)
    emit(
        "build", seconds=time.perf_counter() - t0, library=str(path),
        nvcc_seconds=build.build_seconds(),
    )


def phase_kernel_check(seed: int) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, dtype):
        return torch.randn(
            shape, generator=gen, device=dev, dtype=torch.float32
        ).to(dtype)

    results = []

    def per_agent(n, r, xdt, gdt, offset=0):
        x = randn((n + offset,), xdt)[offset:]
        recv = randn((r, n), xdt)
        w = torch.rand((r + 1,), generator=gen, device=dev)
        mom = randn((n,), gdt)
        got = ops.mixing_sgd_combine(x, recv, w, mom, lr=0.1)
        want = ref.mixing_sgd_combine_ref(x, recv, w, mom, lr=0.1)
        tol = FP32_TOL if xdt == torch.float32 else BF16_TOL
        name = f"per_agent n={n} r={r} x={xdt} g={gdt} offset={offset}"
        results.append({
            "case": name, "tol": tol,
            "max_abs_err": assert_close(got, want, tol, name),
        })

    f32, bf16 = torch.float32, torch.bfloat16
    for n, r in ((1 << 16, 3), (1 << 14, 1), (1 << 15, 6)):
        per_agent(n, r, f32, f32)          # the reference's three cases
    per_agent(65537, 3, f32, f32)          # ragged N: scalar rows
    per_agent(1 << 16, 0, f32, f32)        # no neighbours
    per_agent(65537, 0, f32, f32)          # one row: packs + scalar tail
    per_agent(1 << 16, 3, f32, f32, 1)     # x starts off a 16-byte line
    per_agent(1 << 16, 3, bf16, f32)       # bf16 x, fp32 momentum
    per_agent(1 << 16, 3, bf16, bf16)
    per_agent(65537, 2, bf16, f32)

    def stacked(w_np, n, xdt, gdt):
        idx_np, wt_np = gossip.neighbor_table(w_np)
        idx = torch.from_numpy(idx_np).to(dev)
        wt = torch.from_numpy(wt_np).to(dev)
        a = w_np.shape[0]
        x = randn((a, n), xdt)
        g = randn((a, n), gdt)
        before = x.clone()
        got = ops.mixing_sgd_combine_stacked(x, idx, wt, g, lr=0.05)
        want = ref.mixing_sgd_combine_stacked_ref(x, idx, wt, g, lr=0.05)
        tol = FP32_TOL if xdt == torch.float32 else BF16_TOL
        name = f"stacked a={a} r={idx.shape[1]} n={n} x={xdt} g={gdt}"
        err = assert_close(got, want, tol, name)
        if not torch.equal(x, before):
            raise AssertionError(f"{name}: the kernel wrote into x")
        if got.data_ptr() == x.data_ptr():
            raise AssertionError(f"{name}: out aliases x")
        results.append({"case": name, "tol": tol, "max_abs_err": err})

    ring = ring_matrix(8)
    clique = mixing.ideal_matrix(8)
    for w_np in (ring, clique):            # R = 2 and R = 7
        stacked(w_np, 1 << 20, f32, f32)
        stacked(w_np, 1 << 20, bf16, bf16)
        stacked(w_np, 1 << 20, bf16, f32)
        stacked(w_np, (1 << 20) + 3, bf16, bf16)   # odd row starts
    stacked(np.eye(8), 1 << 16, f32, f32)  # R = 0 table
    torch.cuda.synchronize()
    emit("kernel_check", cases=results)
    return results


def phase_small_reference(seed: int) -> None:
    """The whole slice against a reference on a small input: 3 priced
    steps of the smoke-size model on the card (every update through the
    kernel) against the same run on the CPU (plain version), float32 at
    1e-4. The full-size run below has no reference to agree with, only
    finite values and the per-update checks; this is the one phase that
    holds the card's forward, backward and update, chained over steps,
    to numbers computed elsewhere."""
    cfg = qwen2_0_5b.SMOKE_CONFIG
    m, steps = 4, 3
    w = ring_matrix(m)
    stream = SyntheticTokenStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=16, num_agents=m,
                   dirichlet_alpha=0.3, seed=1)
    )
    base = model.init(cfg, seed, device="cpu")

    def run(device):
        step_fn = dpsgd.make_dpsgd_step(
            lambda p, b: model.loss(cfg, p, {"tokens": b}, remat=False)[0],
            learning_rate=0.05,
        )
        params = dpsgd.replicate_for_agents(
            tree_map(lambda p: p.to(device), base), m
        )
        return train_priced(
            params, step_fn, lambda k: stream.stacked_batch(k, 2), w,
            StaticTau(2.5), steps, log_every=1, device=device,
        )

    p_gpu, log_gpu = run("cuda")
    p_cpu, log_cpu = run("cpu")
    log_gpu.validate()
    loss_err = max(
        abs(a - b) / abs(b) for a, b in zip(log_gpu.losses, log_cpu.losses)
    )
    if not loss_err <= 1e-4:
        raise AssertionError(f"small reference: loss rel err {loss_err}")
    param_err = max(
        float((a.cpu() - b).abs().max())
        for a, b in zip(tree_leaves(p_gpu), tree_leaves(p_cpu))
    )
    if not param_err <= 1e-4:
        raise AssertionError(f"small reference: param abs err {param_err}")
    if log_gpu.wall_clock != log_cpu.wall_clock:
        raise AssertionError("small reference: wall-clock differs")
    emit(
        "small_reference", config=cfg.name, agents=m, steps=steps,
        loss_rel_err=loss_err, param_abs_err=param_err,
        losses=log_gpu.losses, tolerance=1e-4,
    )


def profile_step(step_fn, params, batch, plan, step_ms: list) -> dict:
    """One more D-PSGD step under ``torch.profiler``: device time by
    kernel. The profiler slows the host several times over, so the share
    of a step during which the device ran nothing cannot be read from the
    profiled step itself: it is given as a range, this step's device-busy
    time against the fastest and the slowest unprofiled step of the same
    run (``step_ms``, host clock)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(params, batch, plan, 0)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        # device-side events only: an operator's row repeats the time of
        # the kernels it launched
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {
        "wall_ms_under_profiler": wall_ms,
        "device_busy_ms": device_ms,
        "step_ms_unprofiled": step_ms,
        "device_idle_share_range": [
            max(0.0, 1.0 - device_ms / min(step_ms)),
            max(0.0, 1.0 - device_ms / max(step_ms)),
        ],
        "device_launches": sum(r[2] for r in rows),
        "top_by_device_ms": [
            {"name": k[:80], "ms": ms, "calls": n} for k, ms, n in rows[:14]
        ],
    }


def leaf_scale(leaf: torch.Tensor) -> float:
    """Typical magnitude of a parameter leaf (0.02 for an all-zero one)."""
    return float(leaf.to(torch.float32).abs().mean()) or 0.02


def perturbed_update_check(params, grads, plan, lr: float, seed: int) -> float:
    """``dpsgd.fused_update`` leaf by leaf on parameters to which each
    agent has added its own noise of the leaf's magnitude, against the
    plain version, to one bf16 ulp. Returns the largest error relative to
    its leaf's scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    worst = 0.0
    for (path, p), g in zip(tree_paths(params), tree_leaves(grads)):
        scale = leaf_scale(p)
        noise = torch.empty_like(p).normal_(generator=gen).mul_(scale)
        x = noise.add_(p)
        a = x.shape[0]
        fused = dpsgd.fused_update({"leaf": x}, {"leaf": g}, plan, lr)["leaf"]
        want = ref.mixing_sgd_combine_stacked_ref(
            x.reshape(a, -1), plan.idx, plan.weights, g.reshape(a, -1), lr=lr
        ).reshape(x.shape)
        tight = p.dtype == torch.bfloat16
        err = assert_close(
            fused, want, BF16_ULP_RTOL if tight else FP32_TOL,
            f"perturbed first step {path}",
            atol=(BF16_ULP_ATOL if tight else FP32_TOL) * scale,
        )
        worst = max(worst, err / scale)
        del noise, x, fused, want
    return worst


def phase_train(seed: int, steps: int, seq: int, with_profile: bool = False):
    """Priced D-PSGD on Qwen2-0.5B, unreduced, 8 agents on one card."""
    cfg = qwen2_0_5b.CONFIG
    m, per_agent_batch, lr = 8, 1, 0.05
    dev = torch.device("cuda")
    w = ring_matrix(m)
    stream = SyntheticTokenStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, num_agents=m,
                   dirichlet_alpha=0.3, seed=1)
    )
    batches = {}

    def batcher(k):
        if k not in batches:
            batches[k] = stream.stacked_batch(k, per_agent_batch, seq)
        return batches[k]

    def loss_fn(p, b):
        return model.loss(cfg, p, {"tokens": b}, remat=False)[0]

    t0 = time.perf_counter()
    params = dpsgd.replicate_for_agents(model.init(cfg, seed, device=dev), m)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    n_params = model.parameter_count(cfg)
    leaves = len(tree_leaves(params))
    plan = dpsgd.mixing_plan(w, dev)

    # First step, fused against unfused, from the same parameters and the
    # same gradients.
    batch0 = torch.from_numpy(batcher(0)).to(dev)
    _, grads = dpsgd.agent_grads(loss_fn, params, batch0)
    fused = dpsgd.fused_update(params, grads, plan, lr)
    with torch.no_grad():
        plain = dpsgd.plain_update(params, grads, plan.w, lr)
    first_step_err = 0.0
    for (path, a), b in zip(tree_paths(fused), tree_leaves(plain)):
        first_step_err = max(
            first_step_err, assert_close(a, b, BF16_TOL, f"first step {path}")
        )
    del fused, plain
    torch.cuda.empty_cache()
    # The agents are still identical here, so a wrong neighbour row would
    # not show above. Same update, same gradients, every leaf, with the
    # agents pushed apart first; kernel against its plain version.
    perturbed_err = perturbed_update_check(params, grads, plan, lr, seed)
    del grads
    torch.cuda.empty_cache()

    step_fn = dpsgd.make_dpsgd_step(loss_fn, learning_rate=lr)
    step_ms = []

    def timed_step(p, b, plan_, k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(p, b, plan_, k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    total_steps = steps + 1            # step 0 is the warm-up
    params, log = train_priced(
        params, timed_step, batcher, w, StaticTau(TAU), total_steps,
        design_label="ring-8", log_every=1,
    )
    launches = ops.launch_count()
    torch.cuda.synchronize()
    log.validate()
    if launches != total_steps * leaves:
        raise AssertionError(
            f"launch counter {launches} != steps {total_steps} x leaves "
            f"{leaves}: the update did not go through the kernel"
        )
    if not all(np.isfinite(r.loss) for r in log.records):
        raise AssertionError(f"non-finite loss: {log.losses}")
    if not all(np.isfinite(r.consensus) for r in log.records):
        raise AssertionError("non-finite consensus distance")
    for path, p in tree_paths(params):
        if p.shape[0] != m or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"bad parameters after training: {path}")
    if log.total_wall != sum(r.tau for r in log.records):
        raise AssertionError("wall-clock is not the sum of tau")

    profiled = (
        profile_step(step_fn, params, batcher(total_steps), plan,
                     step_ms[1:])
        if with_profile else None
    )

    # Milliseconds inside the kernel per step: replay one step's launches
    # (every leaf, same plan) between CUDA events.
    zeros = tree_map(torch.zeros_like, params)
    kernel_ms_per_step = time_cuda(
        lambda: dpsgd.fused_update(params, zeros, plan, lr), reps=TIMING_REPS
    )
    del zeros
    torch.cuda.empty_cache()
    emit(
        "train", config=cfg.name, parameters_per_agent=n_params, agents=m,
        leaves=leaves, per_agent_batch=per_agent_batch, seq_len=seq,
        param_dtype=cfg.param_dtype, lr=lr, tau=TAU,
        mixing="ring of 8, alpha=1/3", rho=mixing.rho(w),
        init_seconds=init_seconds, warmup_steps=1, timed_steps=steps,
        steps=[
            {"step": r.step, "loss": r.loss, "consensus": r.consensus,
             "tau": r.tau, "wall_clock": r.wall_clock, "step_ms": ms}
            for r, ms in zip(log.records, step_ms)
        ],
        step_ms_mean_timed=float(np.mean(step_ms[1:])),
        kernel_ms_per_step=kernel_ms_per_step,
        kernel_launches=launches, launches_per_step=leaves,
        first_step_fused_vs_unfused_max_abs_err=first_step_err,
        first_step_tolerance=BF16_TOL,
        perturbed_first_step_max_err_over_scale=perturbed_err,
        perturbed_first_step_tolerance={
            "rtol": BF16_ULP_RTOL, "atol_over_scale": BF16_ULP_ATOL},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profiled,
    )
    return params, plan, launches, leaves


def phase_kernels(params, plan, launches, leaves, seed: int) -> dict:
    """The kernel at the two largest leaves the main path gives it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    lr = 0.05
    by_size = sorted(tree_paths(params), key=lambda pl: -pl[1].numel())[:2]
    a_dim = plan.num_agents
    r = plan.idx.shape[1]

    # Copy bandwidth of this card in this run (read + write of 2 GiB).
    src = torch.empty(1 << 30, dtype=torch.int16, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_cuda(lambda: dst.copy_(src), reps=TIMING_REPS)
    copy_bytes_per_s = 2 * src.numel() * src.element_size() / (copy_ms * 1e-3)
    del src, dst

    shapes = []
    wrong_idx = plan.idx.roll(1, dims=0)   # another agent's neighbours
    for path, leaf in by_size:
        # The leaf's shape, dtype and magnitude with every agent's row drawn
        # on its own, and lr*g of x's order: a wrong row, a wrapped offset
        # or a dropped term changes the result by about its whole value.
        scale = leaf_scale(leaf)
        x = torch.empty_like(leaf.reshape(a_dim, -1))
        x.normal_(generator=gen).mul_(scale)
        n = x.shape[1]
        g = torch.empty_like(x).normal_(generator=gen).mul_(scale / lr)
        w_dense = plan.w.to(x.dtype)
        tight = x.dtype == torch.bfloat16
        rtol = BF16_ULP_RTOL if tight else FP32_TOL
        atol = (BF16_ULP_ATOL if tight else FP32_TOL) * scale

        got = ops.mixing_sgd_combine_stacked(x, plan.idx, plan.weights, g, lr=lr)
        want = ref.mixing_sgd_combine_stacked_ref(
            x, plan.idx, plan.weights, g, lr=lr
        )
        what = f"main-path shape {path}"
        err = assert_close(got, want, rtol, what, atol=atol)
        del want
        # The comparison must be able to fail: the same output held against
        # the plain version of a faulty update has to be refused.
        for fault, bad_idx, bad_lr in (
            ("wrong neighbour rows", wrong_idx, lr),
            ("gradient term dropped", plan.idx, 0.0),
        ):
            faulty = ref.mixing_sgd_combine_stacked_ref(
                x, bad_idx, plan.weights, g, lr=bad_lr
            )
            if compare(got, faulty, rtol, atol)[0]:
                raise AssertionError(
                    f"{what}: the check cannot tell the kernel's output "
                    f"from an update with {fault}"
                )
            del faulty
        del got

        ms = time_cuda(
            lambda: ops.mixing_sgd_combine_stacked(
                x, plan.idx, plan.weights, g, lr=lr
            ),
            reps=TIMING_REPS,
        )
        plain_ms = time_cuda(
            lambda: ref.mixing_sgd_combine_stacked_ref(
                x, plan.idx, plan.weights, g, lr=lr
            ),
            reps=TIMING_REPS,
        )
        unfused_ms = time_cuda(
            lambda: torch.einsum("ab,bn->an", w_dense, x) - lr * g,
            reps=TIMING_REPS,
        )
        # One PyTorch call for the same function with a dense W: a
        # yardstick only, the port never calls it.
        library_ms = time_cuda(
            lambda: torch.addmm(g, w_dense, x, beta=-lr), reps=TIMING_REPS
        )
        moved = (
            x.numel() * x.element_size()        # x read once
            + g.numel() * g.element_size()      # g read once
            + x.numel() * x.element_size()      # out written once
            + plan.idx.numel() * 4 + plan.weights.numel() * 4
        )
        flops = x.numel() * (2 * (r + 1) + 1)
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        shapes.append({
            "leaf": path, "shape": [a_dim, n], "dtype": str(x.dtype),
            "neighbours": r, "data_scale": scale, "rtol": rtol,
            "atol": atol, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_moved_once": moved, "flops": flops,
            "copy_bound_ms": moved / copy_bytes_per_s * 1e3,
            "achieved_bytes_per_s": moved / (ms * 1e-3),
        })
        del g
        torch.cuda.empty_cache()
    top = shapes[0]
    return {
        "name": "mixing_sgd_combine",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "launches_per_step": leaves,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "library_call": "torch.addmm(g, W, x, beta=-lr)",
        "peak_bytes_per_s": PEAK_BYTES_PER_S,
        "copy_bytes_per_s": copy_bytes_per_s,
        "shapes": shapes,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3, help="timed steps")
    ap.add_argument("--seq", type=int, default=512, help="tokens per agent")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step with torch.profiler")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    phase_kernel_check(args.seed)
    phase_small_reference(args.seed)
    params, plan, launches, leaves = phase_train(
        args.seed, args.steps, args.seq, args.profile
    )
    kernel = phase_kernels(params, plan, launches, leaves, args.seed)
    if kernel["launches"] < 1:
        raise AssertionError("the main path never launched the kernel")
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
