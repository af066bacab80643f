#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N] [--steps N] [--seq N] [--profile]

Drives the port's paths at the full width and depth of Qwen2-0.5B on
one card, through the entry points a user calls:

* network pricing — the port's ``net/`` and its float64 torch rollout
  engine price 256 Monte-Carlo rollouts of a 220-agent star in one pass
  on the card (``torch_engine.simulate_rollout_batch``), held to the
  port's numpy engine and to the JAX engine's quantiles;
* training — priced D-PSGD with 8 agents (``model.loss`` →
  ``make_dpsgd_step`` → ``train_priced``), every update through the
  ``mixing_sgd_combine`` kernel, every round charged a τ sample that
  ``StochasticTau.price(engine="torch")`` priced on the card;
* serving — ``launch.serve.build_serve_artifacts``: prefill of 32 prompts
  of 8192 tokens, then greedy decoding of 64 tokens against the KV caches,
  attention through the ``flash_attention`` (prefill) and
  ``decode_attention`` (decode) kernels.

First it builds the hand-written kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc`` (five sources, one process
each, all at once; ``flash_attention`` has two, its ``wgmma`` design for
bf16 at head_dim 64/128 and its ``mma.sync``/FFMA designs for the rest;
``decode_attention`` has two, its ``mma`` design for bf16 and its FFMA
design for float32) and holds each against its plain PyTorch version on
the card, also at the shapes the paths give them, and shows that the
checks refuse a faulty plain version. Needs a CUDA device and ``nvcc``; there is
no CPU path. Any failed phase raises and the script exits non-zero.

Output: one JSON object per phase (``device``, ``build``,
``kernel_check``, ``attention_check``, ``small_reference``, ``rollout``,
``train``,
``serve_check``, ``serve``, ``attention_main_shapes``), then the line
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives,
then
``{"kernels": [...]}`` (one entry per kernel: launches on its path, error
against the plain version, time on the card beside its bound, the plain
version's time and one library call's), and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import qwen2_0_5b
from repro_torch.configs.base import DECODE_32K, ShapeConfig
from repro_torch.core import dpsgd, gossip, mixing
from repro_torch.core.priced_training import (
    StaticTau,
    StochasticTau,
    train_priced,
)
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.net import (
    MarkovLinkModel,
    StochasticScenario,
    Underlay,
    build_overlay,
    compile_incidence,
    compute_categories,
    demands_from_links,
    lowest_degree_nodes,
    mid_path_edges,
    roofnet_like,
    route_direct,
    simulate,
    torch_engine,
)
from repro_torch.net.stochastic import densify_realizations
from repro_torch.net.topology import Graph
from repro_torch.tree import tree_leaves, tree_map, tree_paths

# Published peaks of one H100 SXM (NVIDIA's data sheet): the roofline the
# kernels' bounds are stated against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# kernel -> (source in csrc/ that serves its main path, the TPU kernel it
# replaces). Both attention kernels have two sources, chosen by (dtype,
# head_dim): the main path (bf16, head_dim 64) runs
# flash_attention_wgmma.cu and decode_attention_mma.cu.
KERNELS = {
    "mixing_sgd_combine": (
        "mixing_combine", "src/repro/kernels/mixing_combine.py:38"),
    "flash_attention": (
        "flash_attention_wgmma", "src/repro/kernels/flash_attention.py:96"),
    "decode_attention": (
        "decode_attention_mma", "src/repro/kernels/decode_attention.py:73"),
}
# Every kernel source, built at once (one nvcc process each).
SOURCES = ("mixing_combine", "flash_attention", "flash_attention_wgmma",
           "decode_attention", "decode_attention_mma")

FP32_TOL = 1e-5   # the reference's own (tests/test_kernels.py)
BF16_TOL = 2e-2   # one bf16 rounding vs. the unfused form's two
# Kernel against its plain version in bf16 at the main path's shapes: both
# accumulate in float32 and round once, so they differ by at most one bf16
# ulp of the result (2^-7 of its value) where the two summation orders
# round to different neighbours; atol = BF16_ULP_ATOL x the data's scale
# covers results that cancel to near zero.
BF16_ULP_RTOL = 8e-3
BF16_ULP_ATOL = 1e-4

# Attention kernels against their plain versions on the case tables: the
# JAX package's own tolerances (tests/test_kernels.py), rtol = atol.
ATTN_FP32_TOL = 2e-5
ATTN_BF16_TOL = 2e-2
# At the main path's shapes (bf16) a row's output shrinks with its number
# of keys L as sqrt(e/L) (N(0,1) inputs: about 0.02 at 8k keys), so a fixed
# 2e-2 would be as large as the output. Kernel and plain version both
# accumulate in float32 and round once to bf16 (at most one ulp, 2^-7 of
# the value); the flash kernel also rounds P to bf16 for P.V (2^-9 per
# term, about 1e-3 of the row's RMS). Limit: ATTN_ROW_RTOL x |want| +
# ATTN_ROW_ATOL x the RMS of want over heads and D at each (request,
# query position).
ATTN_ROW_RTOL = 1e-2
ATTN_ROW_ATOL = 2e-2
# Cache slots of one tile of the decode design that serves the main path
# (bf16, Qwen2-0.5B's head_dim): the faulty plain version of the main-path
# check drops one such tile.
DECODE_TILE = decode_mod.tile_slots(
    torch.bfloat16, qwen2_0_5b.CONFIG.resolved_head_dim)
# The case tables of tests/test_kernels.py:
# (b, h, kv, s, d, window, softcap, dtype) and (b, h, kv, s, d, length,
# softcap, dtype).
FLASH_CASES = [
    (2, 4, 2, 128, 64, None, None, torch.float32),
    (1, 8, 4, 256, 64, 64, None, torch.float32),
    (2, 4, 4, 128, 128, None, 50.0, torch.float32),
    (1, 2, 1, 256, 32, 128, 30.0, torch.float32),
    (1, 4, 2, 128, 64, None, None, torch.bfloat16),
    (1, 4, 4, 128, 256, 96, None, torch.bfloat16),
]
DECODE_CASES = [
    (2, 4, 2, 512, 64, 300, None, torch.float32),
    (1, 8, 8, 1024, 128, 1024, None, torch.float32),
    (3, 4, 1, 512, 32, 1, None, torch.float32),
    (2, 4, 2, 512, 64, 511, 50.0, torch.bfloat16),
]
# The wgmma design of flash_attention (bf16, head_dim 64 and 128), run at
# both head_dims: (b, h, kv, sq, sk, causal, window, softcap, layout), with
# layout "model" ([B,S,H,D] storage, transposed views), "dense"
# ([B,H,S,D]) or "fused" (q, k, v sliced from one [B,S,H+2KV,D] tensor).
FLASH_WGMMA_CASES = [
    (2, 14, 2, 1000, 1000, True, 256, 50.0, "model"),  # group 7
    (1, 4, 4, 129, 129, True, None, None, "model"),    # group 1
    (2, 7, 1, 77, 77, True, None, None, "dense"),      # group 7, S = 77
    (3, 2, 2, 1, 1, True, None, None, "model"),        # one token
    (1, 8, 2, 200, 333, False, None, None, "model"),   # Sq < Sk
    (1, 8, 8, 300, 129, False, None, None, "dense"),   # Sq > Sk
    (1, 4, 2, 100, 300, True, None, None, "model"),    # causal, Sq < Sk
    (2, 4, 1, 260, 100, False, 64, 30.0, "model"),     # rows with no key
    (1, 14, 2, 1000, 1000, True, None, None, "fused"),
]
# Decode in float32 at head_dim 256 (32-slot tiles): (b, h, kv, s, d,
# length, softcap, dtype).
DECODE_F32_D256_CASES = [
    (1, 8, 4, 1000, 256, 777, None, torch.float32),
    (2, 8, 4, 1000, 256, 1000, 50.0, torch.float32),
]
# The mma design of decode_attention (bf16): (b, h, kv, s, d, length,
# softcap, layout), layout "model" ([B,S,KV,D] storage, transposed views)
# or "dense" ([B,KV,S,D]); length an int or a list ([B] lengths). Held at
# the data-scaled limit, each asserted to run "mma".
DECODE_MMA_CASES = [
    (2, 16, 1, 300, 64, 300, None, "model"),      # group 16, length = S
    (3, 4, 4, 129, 64, 1, None, "dense"),         # group 1, length 1
    (2, 14, 2, 1000, 64, 999, 50.0, "model"),     # group 7, softcap 50
    (3, 14, 2, 1000, 64, [0, 517, 1000], None, "model"),  # [B], a 0
    (2, 7, 1, 77, 64, 77, None, "dense"),         # S = 77, no whole tile
    (1, 32, 2, 2000, 128, 1999, 50.0, "model"),   # group 16 at D = 128
] + [
    (2, 8, 2, 777, d, 700, None, "model") for d in flash_mod.HEAD_DIMS
] + [
    (2, 8, 4, 8192, 256, 8192, 50.0, "model"),    # Gemma2-2B's decode layer
]

# Serving main path: B prompts of PROMPT tokens, caches MAX_LEN deep,
# NEW_TOKENS greedy tokens (the first from prefill's logits).
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_NEW_TOKENS = 32, 8192, 8256, 64
# End-to-end check: the JAX package's own model tolerances
# (tests/test_models_smoke.py): prefill 2e-2, decode 3e-2, rtol = atol.
CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS = 2, 512, 8
FP32_ORDER_ATOL = 1e-4  # float32 logits summed in another order

TIMING_REPS = 20

# The rollout phase: benchmarks/rollout_scale.py's instance (220-agent
# single-hub star, ring overlay, kappa 1e6 B, Markov fading on every 7th
# uplink, 256 rollouts), priced by the port on the card.
ROLLOUT_AGENTS = 220
ROLLOUTS = 256
ROLLOUT_BASELINE = 32          # rollouts the numpy engine also prices
ROLLOUT_RTOL = 1e-9
ROLLOUT_CPU_LANES = 8          # lanes re-run on the CPU (recorded only)
# The same instance priced by the JAX package's engine (XLA on the CPU):
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c \
#     "from benchmarks import rollout_scale as r; print(r.run())"
JAX_TAU_NOMINAL = 48.343333240333536
JAX_TAU_P95 = 78.1524738472914
JAX_TAU_P99 = 79.64402079241292

# The train phase's pricing: paper_scenario's roofnet_like(seed=0) with the
# 8 lowest-degree agents, one Markov group on the ring's mid-path hops,
# TRAIN_ROLLOUTS samples priced once on the card before training.
TRAIN_ROLLOUTS = 256


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


def time_graph(fn, reps: int, replays: int = 5) -> float:
    """Mean milliseconds of ``fn()`` replayed from a CUDA graph of ``reps``
    calls: the device's time alone, without the host's cost of each eager
    launch (which paces a kernel of tens of microseconds)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def compare(got, want, rtol: float, atol) -> tuple[bool, float, float]:
    """Whether ``got`` is finite and within ``atol + rtol*|want|`` of
    ``want`` everywhere (in float32; ``atol`` a number or a tensor that
    broadcasts to ``want``), the largest absolute error, and the largest
    ratio of error to that limit."""
    g32, w32 = got.to(torch.float32), want.to(torch.float32)
    err = (g32 - w32).abs_()
    limit = w32.abs().mul_(rtol).add_(atol)
    agree = not bool((err > limit).any()) and bool(torch.isfinite(g32).all())
    if not err.numel():
        return agree, 0.0, 0.0
    worst = float(err.div(limit.clamp_min_(1e-30)).max())
    return agree, float(err.max()), worst


def assert_close(got, want, tol: float, what: str, atol=None) -> float:
    """``|got - want| <= atol + tol*|want|`` in float32 (atol = tol unless
    given); returns the largest absolute error."""
    atol = tol if atol is None else atol
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{what}: {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}"
        )
    agree, max_err, worst = compare(got, want, tol, atol)
    if not agree:
        shown = "per row" if torch.is_tensor(atol) else atol
        raise AssertionError(
            f"{what}: kernel and plain version disagree beyond "
            f"rtol={tol} atol={shown} (max abs err {max_err}, largest "
            f"error over limit {worst})"
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
    """All kernel sources at once, one nvcc process each."""
    t0 = time.perf_counter()
    paths = build.build_all(SOURCES, verbose=True)
    emit(
        "build", seconds=time.perf_counter() - t0,
        libraries={name: str(path) for name, path in paths.items()},
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


# ---------------------------------------------------------------------------
# Network pricing: the rollout engine on the card
# ---------------------------------------------------------------------------


def star_instance(num_agents: int = ROLLOUT_AGENTS, seed: int = 11):
    """benchmarks/rollout_scale.py's ``make_instance`` with the port's own
    ``net/``: a single-hub star with uplinks 125 kB/s x U(0.3, 3.0) from
    ``default_rng(seed)``, a ring overlay routed direct at kappa 1e6 B —
    B = E = 2 x num_agents, every table at degree 2."""
    g = Graph()
    rng = np.random.default_rng(seed)
    hub = num_agents
    for a in range(num_agents):
        g.add_edge(a, hub, capacity=125_000.0 * rng.uniform(0.3, 3.0))
    ov = build_overlay(Underlay(graph=g), list(range(num_agents)))
    cats = compute_categories(ov)
    links = sorted({
        (min(a, b), max(a, b))
        for a, b in ((i, (i + 1) % num_agents) for i in range(num_agents))
    })
    demands = demands_from_links(links, 1e6, num_agents)
    return route_direct(demands, cats, 1e6), ov


def star_scenario(tau: float) -> StochasticScenario:
    """Correlated fading on every 7th uplink: a two-state Markov chain
    takes the link to 35 % of nominal, re-drawn on a 0.4 tau grid over a
    4 tau horizon (benchmarks/rollout_scale.py)."""
    flaky = tuple((a, ROLLOUT_AGENTS) for a in range(0, ROLLOUT_AGENTS, 7))
    return StochasticScenario(
        links=(MarkovLinkModel(
            edges=flaky, scales=(1.0, 0.35),
            transition=((0.8, 0.2), (0.5, 0.5)),
        ),),
        step=0.4 * tau, horizon=4 * tau,
    )


def phase_rollout(with_profile: bool = False) -> None:
    """Price 256 rollouts of the 220-agent star on the card in one pass of
    the torch engine (one warm call, one timed), hold the first 32 to the
    port's numpy engine and the quantiles to the JAX engine's, both at
    rtol 1e-9."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    sol, ov = star_instance()
    inc = compile_incidence(sol, ov)
    tau = simulate(sol, ov, engine="batched", incidence=inc).makespan
    scenario = star_scenario(tau)
    reals = tuple(scenario.sample((13, r)) for r in range(ROLLOUTS))
    batch = densify_realizations(reals, inc)
    setup_s = time.perf_counter() - t0

    def price():
        return torch_engine.simulate_rollout_batch(
            sol, ov, batch, incidence=inc, device=None)

    t0 = time.perf_counter()
    price()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch_engine.reset_sync_count()
    t0 = time.perf_counter()
    priced = price()
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    syncs, rounds = torch_engine.sync_count(), torch_engine.round_count()

    t0 = time.perf_counter()
    baseline = [
        simulate(sol, ov, scenario=sc, engine="batched", incidence=inc)
        for sc in batch.realizations[:ROLLOUT_BASELINE]
    ]
    numpy_s = (time.perf_counter() - t0) / ROLLOUT_BASELINE
    worst = 0.0
    for r, (got, want) in enumerate(zip(priced, baseline)):
        for a, b in zip((got.makespan, *got.flow_completion),
                        (want.makespan, *want.flow_completion)):
            if not abs(a - b) <= ROLLOUT_RTOL * abs(b):
                raise AssertionError(
                    f"rollout {r}: card {a!r} vs numpy engine {b!r} beyond "
                    f"rtol {ROLLOUT_RTOL}")
            worst = max(worst, abs(a - b) / abs(b))

    makespans = np.array([res.makespan for res in priced])
    quantiles = {
        "tau_nominal": tau,
        "tau_p95": float(np.percentile(makespans, 95)),
        "tau_p99": float(np.percentile(makespans, 99)),
    }
    jax_quantiles = {"tau_nominal": JAX_TAU_NOMINAL,
                     "tau_p95": JAX_TAU_P95, "tau_p99": JAX_TAU_P99}
    jax_rel = {}
    for key, want in jax_quantiles.items():
        got = quantiles[key]
        jax_rel[key] = abs(got - want) / abs(want)
        if not jax_rel[key] <= ROLLOUT_RTOL:
            raise AssertionError(
                f"{key}: card {got!r} vs JAX engine {want!r} beyond rtol "
                f"{ROLLOUT_RTOL}")

    lanes = dataclasses.replace(
        batch, capacity=batch.capacity[:ROLLOUT_CPU_LANES],
        churn=batch.churn[:ROLLOUT_CPU_LANES],
        realizations=batch.realizations[:ROLLOUT_CPU_LANES],
    )
    on_cpu = torch_engine.simulate_rollout_batch(
        sol, ov, lanes, incidence=inc, device="cpu")
    cpu_bitwise = all(
        a.makespan == b.makespan and a.flow_completion == b.flow_completion
        for a, b in zip(on_cpu, priced)
    )
    profiled = profile_step(price, [batch_s * 1e3]) if with_profile else None
    events = np.array([res.num_events for res in priced])
    emit(
        "rollout", agents=ROLLOUT_AGENTS, rollouts=ROLLOUTS,
        branches=inc.num_branches, edges=inc.num_edges,
        phases=int(batch.starts.size), device=str(dev),
        setup_seconds=setup_s, warm_call_seconds=warm_s,
        seconds_per_batch=batch_s, ms_per_rollout=batch_s * 1e3 / ROLLOUTS,
        host_syncs_per_batch=syncs, waterfill_rounds_per_batch=rounds,
        events_per_lane_mean=float(events.mean()),
        events_per_lane_max=int(events.max()),
        numpy_batched_ms_per_rollout=numpy_s * 1e3,
        numpy_over_card_per_rollout=numpy_s / (batch_s / ROLLOUTS),
        parity_rollouts=ROLLOUT_BASELINE, parity_rtol=ROLLOUT_RTOL,
        parity_max_rel_err=worst, **quantiles,
        jax_engine=jax_quantiles, jax_rel_err=jax_rel,
        cpu_lanes=ROLLOUT_CPU_LANES, cpu_lanes_bitwise_equal=cpu_bitwise,
        profile=profiled,
    )


def train_pricer(seed: int, m: int, kappa: float) -> dict:
    """The train phase's pricer: benchmarks.common.paper_scenario's
    instance (roofnet_like(seed=0), the m lowest-degree agents), the ring's
    links routed direct at kappa = one agent's parameter bytes, one Markov
    group on the ring's mid-path hops; ``StochasticTau.price`` on the card
    (``engine="torch"``), ``reduce="sample"``: round k is charged sample
    k mod ``TRAIN_ROLLOUTS``."""
    u = roofnet_like(seed=0)
    ov = build_overlay(u, lowest_degree_nodes(u, m))
    cats = compute_categories(ov)
    links = tuple(sorted({(min(i, (i + 1) % m), max(i, (i + 1) % m))
                          for i in range(m)}))
    sol = route_direct(demands_from_links(links, kappa, m), cats, kappa)
    tau = float(sol.completion_time)
    sto = StochasticScenario(
        links=(MarkovLinkModel(
            edges=mid_path_edges(ov, links), scales=(1.0, 0.2),
            transition=((0.8, 0.2), (0.3, 0.7)),
        ),),
        step=max(tau / 2, 1.0), horizon=4 * max(tau, 1.0),
    )
    outcome = types.SimpleNamespace(
        routing=sol, design=types.SimpleNamespace(activated_links=links),
        tau=tau, tau_samples=(), name=f"ring-{m}",
    )
    torch_engine.reset_sync_count()
    t0 = time.perf_counter()
    pricer = StochasticTau.price(
        outcome, ov, sto, rollouts=TRAIN_ROLLOUTS, seed=seed,
        engine="torch", reduce="sample", routing_cache={}, device=None,
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    samples = np.array(pricer.samples)
    if not (np.all(np.isfinite(samples)) and np.all(samples > 0)):
        raise AssertionError(f"train pricing: bad tau samples {samples}")
    return {
        "pricer": pricer,
        "fields": {
            "pricing": pricer.kind, "kappa_bytes": kappa,
            "routed_tau": tau, "rollouts": TRAIN_ROLLOUTS,
            "markov_edges": len(sto.links[0].edges),
            "tau_mean": pricer.tau_mean, "tau_p95": pricer.tau_p95,
            "tau_min": float(samples.min()), "tau_max": float(samples.max()),
            "pricing_seconds": seconds,
            "pricing_host_syncs": torch_engine.sync_count(),
        },
    }


def profile_step(step, step_ms: list) -> dict:
    """One more step (``step()``) under ``torch.profiler``: device time by
    kernel. The profiler slows the host several times over, so the share
    of a step during which the device ran nothing cannot be read from the
    profiled step itself: it is given as a range, this step's device-busy
    time against the fastest and the slowest unprofiled step of the same
    run (``step_ms``, host clock)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
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
    """Priced D-PSGD on Qwen2-0.5B, unreduced, 8 agents on one card; every
    round is charged a τ sample priced on the card before training
    (``train_pricer``), so the step itself is what it was with a constant
    price."""
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

    kappa = float(n_params * compat.dtype_of(cfg.param_dtype).itemsize)
    priced = train_pricer(seed, m, kappa)
    pricer = priced["pricer"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    total_steps = steps + 1            # step 0 is the warm-up
    params, log = train_priced(
        params, timed_step, batcher, w, pricer, total_steps,
        design_label="ring-8", log_every=1,
    )
    launches = ops.launch_count("mixing_sgd_combine")
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
    for k, r in enumerate(log.records):
        if r.tau != pricer.samples[k % len(pricer.samples)]:
            raise AssertionError(
                f"step {k} charged {r.tau!r}, not its sample "
                f"{pricer.samples[k % len(pricer.samples)]!r}")

    batch = batcher(total_steps)
    profiled = (
        profile_step(lambda: step_fn(params, batch, plan, 0), step_ms[1:])
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
        param_dtype=cfg.param_dtype, lr=lr, **priced["fields"],
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
        **kernel_fields("mixing_sgd_combine"),
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


def kernel_fields(name: str) -> dict:
    src, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}.cu",
        "replaces": replaces,
    }


# ---------------------------------------------------------------------------
# Attention kernels against their plain versions
# ---------------------------------------------------------------------------


def attn_inputs(gen, b, h, kv, sq, sk, d, dtype, model_layout=True):
    """q ``[b,h,sq,d]``, k/v ``[b,kv,sk,d]`` drawn N(0,1), so attention is
    far from uniform and a wrong head map or mask moves the output past
    the tolerance. ``model_layout``: stored ``[B,S,H,D]`` and handed over
    as transposed views, as the model does."""
    def draw(n_heads, s):
        shape = (b, s, n_heads, d) if model_layout else (b, n_heads, s, d)
        t = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return t.transpose(1, 2) if model_layout else t

    return draw(h, sq), draw(kv, sk), draw(kv, sk)


def attn_limit(want, scaled: bool) -> tuple[float, float | torch.Tensor]:
    """(rtol, atol) for an attention output ``want [B,H,S,D]``: the case
    tables' fixed tolerance, or (``scaled``, the main path's shapes)
    ATTN_ROW_RTOL and ATTN_ROW_ATOL x the RMS of ``want`` over heads and D
    at each (request, position)."""
    if scaled:
        rms = want.to(torch.float32).square().mean(dim=(1, 3), keepdim=True)
        return ATTN_ROW_RTOL, rms.sqrt_().mul_(ATTN_ROW_ATOL)
    tol = ATTN_FP32_TOL if want.dtype == torch.float32 else ATTN_BF16_TOL
    return tol, tol


def hold(what: str, got, want, scaled: bool) -> dict:
    """Kernel output against its plain version at ``attn_limit``."""
    rtol, atol = attn_limit(want, scaled)
    err = assert_close(got, want, rtol, what, atol=atol)
    worst = compare(got, want, rtol, atol)[2]
    return {
        "case": what, "rtol": rtol,
        "atol": f"{ATTN_ROW_ATOL} x row RMS" if scaled else atol,
        "max_abs_err": err, "largest_err_over_limit": worst,
    }


def check_flash(what, q, k, v, window=None, softcap=None, requests=None,
                causal=True):
    """Kernel on the whole batch. Plain version on the whole batch at the
    tables' tolerance, or (``requests``, the main path's shapes) request by
    request on those listed, at the data-scaled limit. Returns (result,
    kernel output); the result names the design that ran."""
    before = flash_mod.launch_count_by_design()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    after = flash_mod.launch_count_by_design()
    ran = [name for name in after if after[name] != before[name]]
    picked = [slice(None)] if requests is None else [
        slice(i, i + 1) for i in requests]
    held = []
    for r in picked:
        want = ref.flash_attention_ref(q[r], k[r], v[r], causal=causal,
                                       window=window, softcap=softcap)
        held.append(hold(what, got[r], want, scaled=requests is not None))
        del want
    res = max(held, key=lambda h: h["largest_err_over_limit"])
    res["max_abs_err"] = max(h["max_abs_err"] for h in held)
    res["design"] = ran[0] if len(ran) == 1 else ran
    if requests is not None:
        res["plain_version_on_requests"] = list(requests)
    return res, got


def check_decode(what, q, k, v, length, softcap=None, scaled=False):
    """Kernel against its plain version; the result names the design that
    ran, which must be the one ``design()`` gives."""
    before = decode_mod.launch_count_by_design()
    got = ops.decode_attention(q, k, v, length, softcap=softcap)
    after = decode_mod.launch_count_by_design()
    ran = [name for name in after if after[name] != before[name]]
    if ran != [decode_mod.design(q.dtype, q.shape[-1])]:
        raise AssertionError(f"{what}: ran {ran}")
    want = ref.decode_attention_ref(q, k, v, length, softcap=softcap)
    res = hold(what, got, want, scaled)
    res["design"] = ran[0]
    return res, got


def refuse(what: str, got, faulty, scaled: bool) -> dict:
    """The comparison must be able to fail: ``got`` held against the plain
    version of a faulty kernel, at the same limit, has to be refused."""
    rtol, atol = attn_limit(faulty, scaled)
    agree, _, worst = compare(got, faulty, rtol, atol)
    if agree:
        raise AssertionError(
            f"the check cannot tell the kernel's output from {what}"
        )
    return {"fault": what, "largest_err_over_limit": worst}


def strict_causal_plain(q, k, v):
    """The plain flash version with the causal diagonal excluded
    (key j valid for query i only when j < i)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, kv, h // kv, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * d**-0.5
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(-1)
    s = s.masked_fill_(~valid, ref.NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill_(~valid, 0.0)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return out.reshape(b, h, sq, d).to(q.dtype)


def head_mod_plain(q, k, v):
    """The plain flash version with query head h on KV head h % KV."""
    h, kv = q.shape[1], k.shape[1]
    heads = torch.tensor([i % kv for i in range(h)], device=q.device)
    return ref.flash_attention_ref(
        q, k.index_select(1, heads), v.index_select(1, heads), causal=True
    )


def phase_attention_check(seed: int) -> list[dict]:
    """Both attention kernels against their plain versions on the card at
    small shapes: the case tables of tests/test_kernels.py, ragged S,
    ``length`` as a [B] vector, and head_dim 16 of the smoke configs; the
    wgmma design of flash_attention at head_dim 64 and 128
    (``FLASH_WGMMA_CASES``: window with softcap, non-causal Sq != Sk, S in
    {1, 77, 129, 1000}, groups of 1 and 7, strided and fused views, rows
    with no key), asserting that design ran; decode in float32 at head_dim
    256; the mma design of decode_attention (``DECODE_MMA_CASES``: groups
    1, 7 and 16, every head_dim, length 1 and S, S = 77, softcap 50, [B]
    lengths with a 0 (zeros exactly), strided views, Gemma2-2B's decode
    layer) at the data-scaled limit, asserting that design ran. Every
    decode call must run the design ``design()`` names. Also shows that
    the check refuses a decode plain version with ``length - 1``. The main
    path's shapes are held in ``phase_attention_kernels``."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    f32, bf16 = torch.float32, torch.bfloat16
    results, refused = [], []

    for b, h, kv, s, d, window, cap, dt in FLASH_CASES:
        q, k, v = attn_inputs(gen, b, h, kv, s, s, d, dt, model_layout=False)
        results.append(check_flash(
            f"flash table b={b} h={h} kv={kv} s={s} d={d} window={window} "
            f"softcap={cap} {dt}", q, k, v, window, cap)[0])
    for b, h, kv, s, d, window, cap, dt in (
        (2, 14, 2, 1000, 64, None, None, bf16),   # ragged S, group of 7
        (1, 4, 2, 77, 128, 20, 30.0, f32),        # ragged S, window, softcap
        (1, 2, 1, 130, 256, None, None, f32),     # fp32 at head_dim 256
        (2, 4, 2, 33, 16, None, None, f32),       # the smoke configs' head_dim
        (2, 4, 2, 33, 16, 16, 50.0, bf16),
    ):
        q, k, v = attn_inputs(gen, b, h, kv, s, s, d, dt)
        results.append(check_flash(
            f"flash b={b} h={h} kv={kv} s={s} d={d} window={window} "
            f"softcap={cap} {dt} (model layout)", q, k, v, window, cap)[0])

    for d in (64, 128):
        for b, h, kv, sq, sk, causal, window, cap, layout in FLASH_WGMMA_CASES:
            if layout == "fused":
                t = torch.randn((b, sq, h + 2 * kv, d), generator=gen,
                                device="cuda").to(bf16)
                q, k, v = (t[:, :, :h].transpose(1, 2),
                           t[:, :, h:h + kv].transpose(1, 2),
                           t[:, :, h + kv:].transpose(1, 2))
            else:
                q, k, v = attn_inputs(gen, b, h, kv, sq, sk, d, bf16,
                                      model_layout=layout == "model")
            res, got = check_flash(
                f"flash b={b} h={h} kv={kv} sq={sq} sk={sk} d={d} "
                f"causal={causal} window={window} softcap={cap} bf16 "
                f"({layout} layout)", q, k, v, window, cap, causal=causal)
            if res["design"] != "wgmma":
                raise AssertionError(f"{res['case']} ran {res['design']}")
            results.append(res)
            if window is not None and not causal and sq > sk - 1 + window:
                # rows that see no key are zeros, exactly
                if bool(got[:, :, sk - 1 + window:].ne(0).any()):
                    raise AssertionError(f"{res['case']}: keyless rows not 0")

    for b, h, kv, s, d, length, cap, dt in DECODE_CASES + DECODE_F32_D256_CASES:
        q, k, v = attn_inputs(gen, b, h, kv, 1, s, d, dt, model_layout=False)
        results.append(check_decode(
            f"decode table b={b} h={h} kv={kv} s={s} d={d} length={length} "
            f"softcap={cap} {dt}", q, k, v, length, cap)[0])
    vec_cases = (
        (3, 8, 2, 300, 128, [1, 2, 300], 50.0, f32),
        (2, 4, 2, 40, 16, [1, 40], None, f32),
    )
    for b, h, kv, s, d, lengths, cap, dt in vec_cases:
        q, k, v = attn_inputs(gen, b, h, kv, 1, s, d, dt)
        length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        res, got = check_decode(
            f"decode b={b} h={h} kv={kv} s={s} d={d} length={lengths} "
            f"softcap={cap} {dt} (model layout)", q, k, v, length, cap)
        results.append(res)
        refused.append(refuse(
            f"a decode plain version with length - 1 ({res['case']})",
            got, ref.decode_attention_ref(q, k, v, length - 1, softcap=cap),
            scaled=False))
    q, k, v = attn_inputs(gen, 2, 4, 2, 1, 700, 64, f32)
    results.append(check_decode(
        "decode length as a 0-d int32 tensor", q, k, v,
        torch.tensor(650, dtype=torch.int32, device="cuda"))[0])

    for b, h, kv, s, d, length, cap, layout in DECODE_MMA_CASES:
        q, k, v = attn_inputs(gen, b, h, kv, 1, s, d, bf16,
                              model_layout=layout == "model")
        n = (torch.tensor(length, dtype=torch.int32, device="cuda")
             if isinstance(length, list) else length)
        res, got = check_decode(
            f"decode b={b} h={h} kv={kv} s={s} d={d} length={length} "
            f"softcap={cap} bf16 ({layout} layout)", q, k, v, n, cap,
            scaled=True)
        if res["design"] != "mma":
            raise AssertionError(f"{res['case']} ran {res['design']}")
        results.append(res)
        lengths = length if isinstance(length, list) else [length] * b
        for i, li in enumerate(lengths):
            if li == 0 and bool(got[i].ne(0).any()):
                raise AssertionError("decode with length 0 is not zeros")
        del q, k, v, got
    torch.cuda.synchronize()
    emit("attention_check", cases=results, refused=refused)
    return results


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def serve_params(cfg, seed: int):
    """Random parameters of ``cfg`` on the card from an explicit generator
    (the repo holds no checkpoint)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    return model.init(cfg, gen, device="cuda")


def phase_serve_check(seed: int) -> None:
    """The serving path end to end on the card: prefill of a 512-token
    prompt and 8 teacher-forced decode steps of Qwen2-0.5B at full width
    and depth, against ``model.forward`` (torch ops, no kernel) at the
    same positions.

    * float32 (the config with float32 parameters and compute, so the
      kernels' float32 paths): within the JAX package's own model
      tolerances, 2e-2 prefill / 3e-2 decode (tests/test_models_smoke.py).
    * bfloat16 (the served config): two bf16 paths through 24 layers
      round the residual stream differently and part by several bf16
      ulps at the logits, more than 2e-2 (0.0625 in the first run), so
      each is held against the float32 forward of the same parameters:
      the kernel path may be at most twice as far from it as the torch-op
      path is, plus 1e-4 (float32 summation order).
    """
    cfg = qwen2_0_5b.CONFIG
    cfg32 = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"
    )
    b, s, steps = CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS
    params = serve_params(cfg, seed)
    rng = np.random.default_rng(seed + 6)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s + steps), dtype=np.int32)
    ).to("cuda")

    def run(c, p):
        """(serving path's logits, forward's) at positions s-1 .. s+steps-1."""
        art = serve.build_serve_artifacts(
            c, ShapeConfig("serve_check", s + steps, b, "prefill")
        )
        with torch.inference_mode():
            want, _ = model.forward(c, p, {"tokens": toks}, remat=False)
        logits, caches = art.prefill_fn(p, {"tokens": toks[:, :s]})
        got = [logits[:, 0]]
        for t in range(steps):
            logits, caches = art.step_fn(p, caches, toks[:, s + t:s + t + 1])
            got.append(logits[:, 0])
        pos = {key: c_["pos"].tolist() for key, c_ in caches.items()}
        if any(v != [s + steps] * c.num_groups for v in pos.values()):
            raise AssertionError(f"serve_check: cache positions {pos}")
        return torch.stack(got, dim=1), want[:, s - 1:s + steps]

    got32, truth = run(cfg32, tree_map(lambda p: p.to(torch.float32), params))
    err32 = {
        "prefill": assert_close(got32[:, 0], truth[:, 0], 2e-2,
                                "serve_check float32 prefill logits"),
        "decode": assert_close(got32[:, 1:], truth[:, 1:], 3e-2,
                               "serve_check float32 decode logits"),
    }
    got16, want16 = run(cfg, params)
    kernel_err = (got16 - truth).abs()
    forward_err = (want16 - truth).abs()
    bf16 = {
        "kernel_path_vs_fp32_max": float(kernel_err.max()),
        "kernel_path_vs_fp32_mean": float(kernel_err.mean()),
        "forward_vs_fp32_max": float(forward_err.max()),
        "forward_vs_fp32_mean": float(forward_err.mean()),
        "kernel_path_vs_forward_max": float((got16 - want16).abs().max()),
    }
    if not bool(torch.isfinite(got16).all()) or not (
        bf16["kernel_path_vs_fp32_max"]
        <= 2 * bf16["forward_vs_fp32_max"] + FP32_ORDER_ATOL
    ):
        raise AssertionError(f"serve_check bfloat16: {bf16}")
    emit(
        "serve_check", config=cfg.name, batch=b, prompt=s,
        decode_steps=steps, float32_max_abs_err=err32,
        float32_tolerance={"prefill": 2e-2, "decode": 3e-2},
        bfloat16=bf16, bfloat16_rule="kernel path vs fp32 <= 2 x forward vs fp32 + 1e-4",
        logit_scale=float(truth.abs().mean()),
    )


def phase_serve(seed: int, with_profile: bool = False) -> dict:
    """The serving main path: B prompts through ``prefill_fn``, then greedy
    decoding (the first token from prefill's logits, then one ``step_fn``
    call per token), as examples/serve_decode.py does. Launch counters are
    set to 0 just before and read just after. ``with_profile``: one more
    decode step (into the cache's last slot) under the profiler. Returns
    the counts: every kernel's launches in the run, flash launches in the
    prefill and decode launches in the first step."""
    cfg = qwen2_0_5b.CONFIG
    b, prompt, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN
    steps = SERVE_NEW_TOKENS - 1
    art = serve.build_serve_artifacts(
        cfg, ShapeConfig("serve_8k", max_len, b, "prefill")
    )
    params = serve_params(cfg, seed)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, prompt), dtype=np.int32)
    ).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_count()
    t0 = time.perf_counter()
    logits, caches = art.prefill_fn(params, {"tokens": tokens})
    token = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    flash_per_prefill = ops.launch_count("flash_attention")
    flash_designs = flash_mod.launch_count_by_design()
    generated = [token]
    step_ms, decode_per_step = [], []
    for _ in range(steps):
        before = ops.launch_count("decode_attention")
        t = time.perf_counter()
        logits, caches = art.step_fn(params, caches, token)
        token = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        decode_per_step.append(ops.launch_count("decode_attention") - before)
        generated.append(token)
    launches = {name: ops.launch_count(name) for name in KERNELS}
    decode_designs = decode_mod.launch_count_by_design()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    layers = cfg.num_layers
    if flash_per_prefill != layers:
        raise AssertionError(
            f"prefill launched flash_attention {flash_per_prefill} times, "
            f"not once per layer ({layers})")
    want_design = flash_mod.design(torch.bfloat16, cfg.resolved_head_dim)
    if want_design != "wgmma" or flash_designs != {
            **dict.fromkeys(flash_mod.DESIGNS, 0), "wgmma": layers}:
        raise AssertionError(
            f"prefill's flash_attention launches by design {flash_designs}: "
            f"not all {layers} through wgmma")
    if any(n != layers for n in decode_per_step):
        raise AssertionError(
            f"decode steps launched decode_attention {decode_per_step} "
            f"times, not once per layer ({layers})")
    want_design = decode_mod.design(torch.bfloat16, cfg.resolved_head_dim)
    if want_design != "mma" or decode_designs != {
            **dict.fromkeys(decode_mod.DESIGNS, 0), "mma": layers * steps}:
        raise AssertionError(
            f"decode's launches by design {decode_designs}: not all "
            f"{layers * steps} through mma")
    if launches["flash_attention"] != layers or launches["mixing_sgd_combine"]:
        raise AssertionError(f"serving path launch counts {launches}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite decode logits")
    out = torch.cat(generated, dim=1)
    if out.shape != (b, SERVE_NEW_TOKENS) or not bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()
    ):
        raise AssertionError(f"bad generated tokens {tuple(out.shape)}")
    pos = {key: c["pos"].tolist() for key, c in caches.items()}
    if any(p != [prompt + steps] * cfg.num_groups for p in pos.values()):
        raise AssertionError(f"cache positions after decoding: {pos}")
    cache_gb = sum(t.numel() * t.element_size()
                   for c in caches.values() for t in c.values()) / 1e9
    decode_s = sum(step_ms) / 1e3
    profiled = (
        profile_step(lambda: art.step_fn(params, caches, token), step_ms[1:])
        if with_profile else None
    )
    emit(
        "serve", config=cfg.name, batch=b, prompt=prompt, max_len=max_len,
        new_tokens=SERVE_NEW_TOKENS, prefill_seconds=prefill_s,
        prefill_tokens_per_s=b * prompt / prefill_s,
        decode_step_ms=step_ms,
        decode_step_ms_mean_after_first=float(np.mean(step_ms[1:])),
        decode_tokens_per_s=b * steps / decode_s,
        peak_memory_gb=peak_gb, cache_gb=cache_gb,
        flash_launches_per_prefill=flash_per_prefill,
        flash_launches_per_prefill_by_design=flash_designs,
        decode_launches_per_step=decode_per_step[0],
        decode_launches_by_design=decode_designs,
        launches=launches, sample=out[0, :16].tolist(), profile=profiled,
    )
    del params, caches, logits
    torch.cuda.empty_cache()
    return {"launches": launches, "flash_per_prefill": flash_per_prefill,
            "decode_per_step": decode_per_step[0],
            "decode_by_design": decode_designs}


# ---------------------------------------------------------------------------
# Kernel times
# ---------------------------------------------------------------------------


def library_attention(q, k, v, causal: bool):
    """One PyTorch call for the same function: a yardstick timed here,
    never called by the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True
        )


def flash_flops(q, window=None) -> int:
    """4·B·H·D flops per live causal (window) (query, key) pair."""
    b, h, sq, d = q.shape
    live = sum(min(i + 1, window or i + 1) for i in range(sq))
    return 4 * b * h * d * live


def flash_bound(q, k, window=None) -> tuple[float, str]:
    """Least ms: the live pairs' flops at the bf16 tensor-core peak, or
    q, k, v, o moved once at the memory rate."""
    t_ops = flash_flops(q, window) / PEAK_BF16_FLOPS * 1e3
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def decode_bound(q, k, length: int) -> tuple[float, str]:
    """Least ms: K and V up to ``length`` plus q and o moved once."""
    b, kv, _, d = k.shape
    moved = (2 * b * kv * length * d + 2 * q.numel()) * q.element_size()
    return moved / PEAK_BYTES_PER_S * 1e3, "bytes"


def tile_dropped_plain(q, k, v, length: int, start: int):
    """The plain decode version with cache slots ``start`` ..
    ``start + DECODE_TILE - 1`` left out (a kernel that skips one tile)."""
    s, dev = k.shape[2], k.device
    keep = torch.cat([torch.arange(start, device=dev),
                      torch.arange(start + DECODE_TILE, s, device=dev)])
    return ref.decode_attention_ref(
        q, k.index_select(2, keep), v.index_select(2, keep),
        length - DECODE_TILE)


def phase_attention_kernels(seed: int, serve_run: dict | None = None
                            ) -> list[dict]:
    """The attention kernels at the main path's shapes, each held against
    its plain version at the data-scaled limit (``attn_limit``) and timed
    with its plain version and one library call:

    * Qwen2-0.5B's prefill layer, plain version on the first and the last
      request (a full-batch fp32 logit tensor would be 120 GB); the limit
      refuses, on the query rows of the later half, a plain version with
      ``kv = h % KV`` and one with the causal diagonal excluded;
    * a head_dim-128 layer, Mixtral-8x7B's 32 heads / 8 KV heads at batch
      4, with the same controls and SDPA's time beside the kernel's;
    * the served decode step and DECODE_32K's decode layer (also with
      ragged [B] lengths); at both, the limit refuses a plain version with
      ``length - 1`` and one with a tile of the cache left out;
    * Gemma2-2B's local layer (window 4096, softcap 50), both requests,
      timed beside its bound (no library call computes it).

    ``serve_run``: ``phase_serve``'s counts, put in the entries; without
    it the entries carry no launch counts."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    cfg = qwen2_0_5b.CONFIG
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    cases, refused = [], []

    q, k, v = attn_inputs(gen, SERVE_BATCH, h, kv, SERVE_PROMPT,
                          SERVE_PROMPT, d, bf16)
    res, got = check_flash(
        f"flash Qwen2-0.5B prefill layer q={list(q.shape)} "
        f"k={list(k.shape)} bf16", q, k, v, requests=(0, SERVE_BATCH - 1))
    cases.append(res)
    late = slice(SERVE_PROMPT // 2, None)
    for fault, faulty in (("kv = h % KV", head_mod_plain),
                          ("the causal diagonal excluded", strict_causal_plain)):
        bad = faulty(q[:1], k[:1], v[:1])
        refused.append(refuse(
            f"a flash plain version with {fault} (prefill layer, request 0, "
            f"query rows from {SERVE_PROMPT // 2})",
            got[:1, :, late], bad[:, :, late], scaled=True))
        del bad
    del got
    torch.cuda.empty_cache()
    flash_ms = time_cuda(lambda: ops.flash_attention(q, k, v),
                         reps=TIMING_REPS)

    def plain_by_request():
        for i in range(q.shape[0]):
            ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1])

    flash_plain_ms = time_cuda(plain_by_request, reps=2)
    flash_lib_ms = time_cuda(lambda: library_attention(q, k, v, True),
                             reps=TIMING_REPS)
    bound, by = flash_bound(q, k)
    flash = {
        **kernel_fields("flash_attention"),
        "design": res["design"],
        "max_abs_err": res["max_abs_err"], "ms": flash_ms,
        "plain_ms": flash_plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": flash_lib_ms,
        "library_call": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), flash backend",
        "shape": {"q": list(q.shape), "k": list(k.shape), "dtype": "bf16"},
        "live_tflops_per_s": flash_flops(q) / (flash_ms * 1e-3) / 1e12,
        "ms_over_library_ms": flash_ms / flash_lib_ms,
        "plain_note": f"plain version run request by request, {SERVE_BATCH} calls",
    }
    del q, k, v
    torch.cuda.empty_cache()

    # head_dim 128: Mixtral-8x7B's attention layer (32 heads, 8 KV heads),
    # batch cut to 4 (the other wgmma instantiation; no model of the port
    # serves it yet), with the same controls and its library time.
    b128 = 4
    q, k, v = attn_inputs(gen, b128, 32, 8, SERVE_PROMPT, SERVE_PROMPT, 128,
                          bf16)
    res, got = check_flash(
        f"flash head_dim-128 layer q={list(q.shape)} k={list(k.shape)} bf16",
        q, k, v, requests=(0, b128 - 1))
    cases.append(res)
    for fault, faulty in (("kv = h % KV", head_mod_plain),
                          ("the causal diagonal excluded", strict_causal_plain)):
        bad = faulty(q[:1], k[:1], v[:1])
        refused.append(refuse(
            f"a flash plain version with {fault} (head_dim-128 layer, "
            f"request 0, query rows from {SERVE_PROMPT // 2})",
            got[:1, :, late], bad[:, :, late], scaled=True))
        del bad
    del got
    torch.cuda.empty_cache()
    ms128 = time_cuda(lambda: ops.flash_attention(q, k, v), reps=TIMING_REPS)
    lib128 = time_cuda(lambda: library_attention(q, k, v, True),
                       reps=TIMING_REPS)
    bound128, by128 = flash_bound(q, k)
    flash["shapes"] = [{
        "case": "head_dim-128 layer (Mixtral-8x7B, batch 4)",
        "q": list(q.shape), "k": list(k.shape), "design": res["design"],
        "max_abs_err": res["max_abs_err"], "ms": ms128,
        "library_ms": lib128, "bound_ms": bound128, "bound_by": by128,
        "live_tflops_per_s": flash_flops(q) / (ms128 * 1e-3) / 1e12,
        "ms_over_library_ms": ms128 / lib128,
    }]
    del q, k, v
    torch.cuda.empty_cache()

    shapes = []
    for name, b, s in (
        ("served decode step", SERVE_BATCH, SERVE_MAX_LEN),
        ("DECODE_32K layer", DECODE_32K.global_batch, DECODE_32K.seq_len),
    ):
        q, k, v = attn_inputs(gen, b, h, kv, 1, s, d, bf16)
        n = torch.tensor(s, dtype=torch.int32, device="cuda")
        what = f"decode {name} q={list(q.shape)} k={list(k.shape)} bf16"
        res, got = check_decode(f"{what} length={s}", q, k, v, n, scaled=True)
        cases.append(res)
        start = s // 2 // DECODE_TILE * DECODE_TILE
        refused.append(refuse(
            f"a decode plain version with length - 1 ({name})", got,
            ref.decode_attention_ref(q, k, v, n - 1), scaled=True))
        refused.append(refuse(
            f"a decode plain version without cache slots {start} .. "
            f"{start + DECODE_TILE - 1} ({name})", got,
            tile_dropped_plain(q, k, v, n, start), scaled=True))
        del got
        if b == DECODE_32K.global_batch:
            ragged = torch.randint(1, s + 1, (b,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            cases.append(check_decode(f"{what} ragged [B] lengths", q, k, v,
                                      ragged, scaled=True)[0])
        torch.cuda.empty_cache()
        def kernel():
            return ops.decode_attention(q, k, v, n)

        def library():
            return library_attention(q, k, v, False)

        ms = time_graph(kernel, reps=TIMING_REPS)
        lib_ms = time_graph(library, reps=TIMING_REPS)
        eager_ms = time_cuda(kernel, reps=TIMING_REPS)
        lib_eager_ms = time_cuda(library, reps=TIMING_REPS)
        plain_ms = time_cuda(
            lambda: ref.decode_attention_ref(q, k, v, n), reps=TIMING_REPS)
        bound, by = decode_bound(q, k, s)
        shapes.append({
            "case": name, "q": list(q.shape), "k": list(k.shape),
            "length": s, "design": res["design"],
            "splits": decode_mod.split_plan(
                b, kv, s, torch.cuda.get_device_properties(0).multi_processor_count,
                decode_mod.resident_blocks(bf16, d, h // kv, q.device),
                DECODE_TILE)[1],
            "max_abs_err": res["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by,
            "achieved_bytes_per_s": bound * PEAK_BYTES_PER_S / ms,
            "eager_ms": eager_ms, "library_eager_ms": lib_eager_ms,
            "ms_over_library_ms": ms / lib_ms,
        })
        del q, k, v
        torch.cuda.empty_cache()
    top = shapes[0]
    decode = {
        **kernel_fields("decode_attention"),
        "design": top["design"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "library_call": "scaled_dot_product_attention(enable_gqa=True), "
                        "flash backend",
        "timing": "ms and library_ms replayed from a CUDA graph of 20 calls "
                  "(device time); eager_ms and library_eager_ms are 20 eager "
                  "calls between CUDA events, as the other kernels are timed",
        "shapes": shapes,
    }

    # Gemma2-2B's local layer (bf16, head_dim 256: the mma_sync design).
    # No single PyTorch call computes a window with a softcap: no library
    # time.
    q, k, v = attn_inputs(gen, 2, 8, 4, 8192, 8192, 256, bf16)
    res, _ = check_flash(
        "flash Gemma2-2B local layer q=[2, 8, 8192, 256] bf16 "
        "window=4096 softcap=50", q, k, v, window=4096, softcap=50.0,
        requests=(0, 1))
    cases.append(res)
    ms_local = time_cuda(
        lambda: ops.flash_attention(q, k, v, window=4096, softcap=50.0),
        reps=TIMING_REPS)
    bound_local, by_local = flash_bound(q, k, window=4096)
    flash["shapes"].append({
        "case": "Gemma2-2B local layer (window 4096, softcap 50)",
        "q": list(q.shape), "k": list(k.shape), "design": res["design"],
        "max_abs_err": res["max_abs_err"], "ms": ms_local,
        "library_ms": None, "bound_ms": bound_local, "bound_by": by_local,
        "live_tflops_per_s": flash_flops(q, 4096) / (ms_local * 1e-3) / 1e12,
    })
    del q, k, v
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit("attention_main_shapes", cases=cases, refused=refused,
         limit={"rtol": ATTN_ROW_RTOL, "atol_over_row_rms": ATTN_ROW_ATOL})

    if serve_run is not None:
        flash["launches"] = serve_run["launches"]["flash_attention"]
        flash["launches_per_prefill"] = serve_run["flash_per_prefill"]
        decode["launches"] = serve_run["launches"]["decode_attention"]
        decode["launches_per_step"] = serve_run["decode_per_step"]
        decode["launches_by_design"] = serve_run["decode_by_design"]
    return [flash, decode]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3, help="timed steps")
    ap.add_argument("--seq", type=int, default=512, help="tokens per agent")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra rollout batch, one extra "
                         "training step and one extra decode step with "
                         "torch.profiler")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    phase_kernel_check(args.seed)
    phase_attention_check(args.seed)
    phase_small_reference(args.seed)
    phase_rollout(args.profile)
    params, plan, launches, leaves = phase_train(
        args.seed, args.steps, args.seq, args.profile
    )
    kernels = [phase_kernels(params, plan, launches, leaves, args.seed)]
    del params, plan
    torch.cuda.empty_cache()
    phase_serve_check(args.seed)
    serve_run = phase_serve(args.seed, args.profile)
    kernels += phase_attention_kernels(args.seed, serve_run)
    for kernel in kernels:
        if kernel["launches"] < 1:
            raise AssertionError(
                f"its path never launched the kernel {kernel['name']}")
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
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
