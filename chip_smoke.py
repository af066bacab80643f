#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N] [--steps N] [--seq N] [--profile]

Drives the port's paths at the full width and depth of Qwen2-0.5B (and,
for serving, of Gemma2-2B, xLSTM-125M and MusicGen-large, and at full
width of Mixtral-8x7B at half its depth, Jamba-1.5-Large at 5 of its 72
layers and LLaVA-NeXT-34B at 8 of its 60) on one card, through the entry
points a user calls:

* network pricing — the port's ``net/`` and its float64 torch rollout
  engine price 256 Monte-Carlo rollouts of a 220-agent star in one pass
  on the card (``torch_engine.simulate_rollout_batch``), held to the
  port's numpy engine and to the JAX engine's quantiles;
* training — priced D-PSGD with 8 agents (``model.loss`` →
  ``make_dpsgd_step`` → ``train_priced``), every update through the
  ``mixing_sgd_combine`` kernel, every round charged a τ sample that
  ``StochasticTau.price(engine="torch")`` priced on the card;
* the launcher's training step — ``launch.train.build_train_artifacts``
  in Qwen2-0.5B's ``data_dp`` layout at microbatch 2 (8 agents × 2 × 512
  tokens), W designed on the card by ``launch.fabric`` and resolved to the
  ``sparse`` gossip (the ``mixing_sgd_combine`` kernel's form without a
  gradient, one launch per leaf), batches through ``data.Prefetcher``;
  the smoke model in every gossip mode against the CPU, and a checkpoint
  round trip (``AsyncCheckpointer``, restore onto 7 agents);
* D-PSGD across ranks — the kernel's per-agent form without momentum
  (what ``gossip.mix_sparse_p2p`` launches on each rank) at the flat
  gossip buffer of all of Qwen2-0.5B against its plain version and
  ``torch.addmm``; then a (1, 1) ``DeviceMesh`` over NCCL at world size 1
  (``launch.mesh.init_mesh``): the launcher's mesh path
  (``build_train_artifacts`` on the mesh, ``data_dp``, 1 agent x 2 x 512
  tokens, the gradients summed over the ``model`` group by NCCL) bitwise
  the one-card step, ``gossip.mix_sparse_flat`` launching the combine
  once, and the serve mesh path (4 prompts of 8192 tokens, 16 greedy
  steps) bitwise the one-card serving path;
* tensor parallelism over "model" inside an agent — two rank processes
  sharing the card on a (1, 2) ``DeviceMesh`` over gloo (NCCL refuses two
  ranks on one device; every collective staged through pinned host
  memory, so a check of values, not of TP speed): Qwen2-0.5B's ``data``
  layout at full width (7 / 1 heads, 75 968 vocabulary rows and 2432 FFN
  columns a rank) held to the one-card launcher step, and Mixtral-8x7B at
  8 layers served at 16 / 4 heads and 7168 expert columns a rank, held to
  the one-card path by the median-position rule; both attention kernels
  timed alone at the TP-local shapes;
* FSDP and expert parallelism over "data" inside an agent — four rank
  processes sharing the card at (data 2, model 2) over gloo: Mixtral-8x7B
  at full width and 2 layers trained in the ``pod`` layout (FSDP gathers
  with reduce-scattered gradients, the 8 experts 4 a data rank behind an
  all-to-all, TP over "model"; a 512-token row a data rank) held to the
  one-card launcher step and a float32 run, and the 8-layer Mixtral
  served under 2-D tensor parallelism (a row a rank) held by the
  median-position rule, each with its faulty controls refused; both
  attention kernels and the per-agent combine at the local shapes;
* the runtime — ``examples/elastic_failover.py`` at full width:
  Qwen2-0.5B x 8 agents trained by D-PSGD while
  ``runtime.design_service`` (pricing on the card's torch engine)
  re-designs W through a link sag, a departure during a pricing outage, a
  second departure, a join and the recovery, the stacked parameters
  re-mapped on the card by ``shrink_state``/``grow_state``; the trail held
  to the JAX service's, int8 and top-k compression of one agent held to
  the CPU's, the kernel held at every membership;
* design — the paper instance designed by the port's designer on the
  card (clique, ring, prim, FMMD-WP, SCA; every weight optimization in
  float64 on the card), held to the JAX designer's supports and τ; the
  paper's gate (``repro_torch.paper``: 120 priced D-PSGD steps of a small
  LM per scheme, FMMD-P ≥ 80 % less modeled time than Clique at equal
  loss); Qwen2-0.5B trained by 10 agents over FMMD-WP's designed W; and
  the m = 1000 eigendecomposition on the host and on the card;
* serving — ``launch.serve.build_serve_artifacts``: prefill of 32 prompts
  of 8192 tokens, then greedy decoding of 64 tokens against the KV caches,
  attention through the ``flash_attention`` (prefill) and
  ``decode_attention`` (decode) kernels; then Gemma2-2B (head_dim 256,
  local window-4096 and global layers, softcap 50) with 8 prompts of 8192
  tokens and 64 greedy tokens through the same two kernels; then
  Mixtral-8x7B at full width and 16 of its 32 layers (MoE FFN of 8
  experts top-2 on every layer, head_dim 128, window 4096) with 4 prompts
  of 8192 tokens and 64 greedy tokens, its MoE layer, attention shapes and
  ``serve_check`` held on the card; then the recurrent blocks and the
  frontends: Jamba-1.5-Large's first 5 layers (Mamba, Mamba + MoE of 16
  experts, NoPE attention at 64 / 8 heads) with 2 prompts of 8192 tokens,
  xLSTM-125M (mLSTM and sLSTM, no attention) with 8 of 2048, LLaVA-NeXT-34B
  (576 patch positions and 3520 tokens, 4 requests) and MusicGen-large
  (multi-head attention at head_dim 64, 8 requests of 1500 codec tokens),
  each with its attention shapes and ``serve_check``.

First it builds the hand-written kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc`` (five sources, one process
each, all at once: ``mixing_combine``; ``flash_attention`` has two,
``flash_attention_wgmma`` for bf16 at every head_dim and
``flash_attention_ffma`` for float32 at every head_dim;
``decode_attention`` has two, ``decode_attention_mma`` for bf16 and
``decode_attention`` (FFMA) for float32) and holds each against its plain
PyTorch version on the card, also at the shapes the paths give them, and
shows that the checks refuse a faulty plain version. Needs a CUDA device
and ``nvcc``; there is no CPU path. Any failed phase raises and the script
exits non-zero.

Output: one JSON object per phase (``device``, ``build``,
``kernel_check``, ``attention_check``, ``small_reference``, ``rollout``,
``train``, ``train_launch``, ``per_agent_flat_combine``, ``mesh_init``,
``train_mesh``, ``serve_mesh``, ``train_tp``, ``serve_tp``,
``tp_local_attention``, ``train_pod``, ``serve_2d``,
``pod_local_attention``, ``pod_local_combine``, ``elastic``, ``design``, ``gate``, ``design_full_width``, ``design_eigh``,
``serve_check`` (Qwen2-0.5B, then Gemma2-2B), ``serve``,
``serve_gemma2``, ``moe_layer_check``, ``mixtral_attention``,
``serve_check`` (Mixtral float32 at 2 layers), ``serve_mixtral``,
``serve_mixtral_step``, ``serve_check`` (Mixtral bf16 at 16 layers),
``serve_mixtral_total``, then for each of Jamba, xLSTM, LLaVA and
MusicGen ``served_attention`` (not xLSTM), ``serve_check`` (Jamba float32
at 2 layers), ``serve_<model>``, ``serve_<model>_step``, ``serve_check``
and ``serve_<model>_total``,
``attention_main_shapes``, ``ffma_times``), then the
line
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
import datetime
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import (
    gemma2_2b,
    jamba_1_5_large_398b,
    llava_next_34b,
    mixtral_8x7b,
    musicgen_large,
    qwen2_0_5b,
    xlstm_125m,
)
from repro_torch.checkpoint import AsyncCheckpointer, restore
from repro_torch.configs.base import (
    ATTN_KINDS,
    DECODE_32K,
    MOE_KINDS,
    ShapeConfig,
    TrainConfig,
    get_train_config,
)
from repro_torch.core import dpsgd, gossip, mixing, weight_opt
from repro_torch.core.fmmd import fmmd_wp
from repro_torch.core.priced_training import (
    StaticTau,
    StochasticTau,
    pricer_for,
    train_priced,
)
from repro_torch.core.sca import sca_design
from repro_torch.core.topology_baselines import (
    clique_design,
    prim_design,
    ring_design,
)
from repro_torch.data import Prefetcher, make_batch_fn
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import fabric, serve, sharding, train
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import (
    attention,
    blocks,
    model,
    moe,
    sharding_hints,
    ssm,
)
from repro_torch.models.layers import mlp_apply
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
from repro_torch.optim import sgd
from repro_torch.paper import fig5_training
from repro_torch.paper import priced_training as paper_gate
from repro_torch.paper import scenario as paper
from repro_torch.runtime import compression, design_service
from repro_torch.runtime.events import AgentJoin, AgentLeave, LinkStateChange
from repro_torch.runtime.fault_tolerance import grow_state, shrink_state
from repro_torch.runtime.faultinject import FaultInjector, FaultPlan
from repro_torch.tree import tree_leaves, tree_map, tree_paths

# Published peaks of one H100 SXM (NVIDIA's data sheet): the roofline the
# kernels' bounds are stated against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# Results a clock of one SM's MUFU, the unit that computes ex2 and tanh:
# 16 on compute capability 9.0 (the CUDA C++ Programming Guide's table of
# arithmetic instruction throughput, "32-bit floating-point reciprocal,
# reciprocal square root, base-2 logarithm, base 2 exponential, sine,
# cosine"). A flash layer's kernels issue one fp32 ex2 a live (query, key)
# pair and one tanh more under a softcap; times the SMs and the max SM
# clock that nvidia-smi reads in the same run (mufu_per_s). This bounds
# that choice of instruction, not the card: exponentials can also run on
# the FMA pipe (a polynomial) or two at a time (ex2.approx.f16x2).
MUFU_PER_CLOCK_PER_SM = 16
L2_BYTES = 50 * 2**20  # the L2 cache

# kernel -> (source in csrc/ that serves its main path, the TPU kernel it
# replaces). The attention kernels have more sources, chosen by (dtype,
# head_dim): flash_attention two (wgmma for bf16 at every head_dim, ffma
# for float32), decode_attention two (mma, ffma). The serving paths (bf16,
# head_dim 64 and 256) run flash_attention_wgmma.cu and
# decode_attention_mma.cu; the float32 serve_check runs and ffma_times run
# flash_attention_ffma.cu and decode_attention.cu.
KERNELS = {
    "mixing_sgd_combine": (
        "mixing_combine", "src/repro/kernels/mixing_combine.py:38"),
    "flash_attention": (
        "flash_attention_wgmma", "src/repro/kernels/flash_attention.py:96"),
    "decode_attention": (
        "decode_attention_mma", "src/repro/kernels/decode_attention.py:73"),
}
# Every kernel source, built at once (one nvcc process each).
SOURCES = ("mixing_combine", "flash_attention_wgmma", "flash_attention_ffma",
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
# The wgmma design of flash_attention (bf16 at every head_dim), run at
# every head_dim in WGMMA_CASE_HEAD_DIMS: (b, h, kv, sq, sk, causal,
# window, softcap, layout), with
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
# A wrong swizzle, LBO/SBO or fragment packing gives garbage at one
# head_dim only, with no fault: every check runs the table at each.
WGMMA_CASE_HEAD_DIMS = (16, 32, 64, 128, 256)
# The ffma design of flash_attention (float32), run at every head_dim: the
# same columns as FLASH_WGMMA_CASES, held at ATTN_FP32_TOL, each asserted
# to run "ffma".
FLASH_FFMA_CASES = FLASH_WGMMA_CASES + [
    (1, 4, 2, 300, 100, True, None, 50.0, "dense"),    # causal, Sq > Sk
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
# The ffma design of decode_attention (float32): the columns of
# DECODE_MMA_CASES, each shape at every head_dim, then Gemma2-2B's decode
# layer at its fp32 serve_check depth. Held at ATTN_FP32_TOL, each asserted
# to run "ffma"; rows of length 0 are zeros exactly.
DECODE_FFMA_CASES = [
    (b, h, kv, s, d, length, cap, layout)
    for d in flash_mod.HEAD_DIMS
    for b, h, kv, s, length, cap, layout in (
        (2, 16, 1, 300, 300, None, "model"),          # group 16, length = S
        (3, 4, 4, 129, 1, None, "dense"),             # group 1, length 1
        (2, 14, 2, 1000, 999, 50.0, "model"),         # group 7, softcap 50
        (3, 14, 2, 1000, [0, 517, 1000], None, "model"),  # [B], a 0
        (2, 7, 1, 77, 77, None, "dense"),             # S = 77, no whole tile
        (2, 4, 2, 100, 0, None, "model"),             # length 0
    )
] + [
    (1, 8, 4, 4616, 256, 4616, 50.0, "model"),    # Gemma2-2B's decode layer
]

# Serving main path: B prompts of PROMPT tokens, caches MAX_LEN deep,
# NEW_TOKENS greedy tokens (the first from prefill's logits).
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_NEW_TOKENS = 32, 8192, 8256, 64
# Gemma2-2B served at full width: 8 prompts of 8192 tokens, global caches
# 8256 deep (local layers keep the 4096-slot ring), 64 greedy tokens.
GEMMA2_SERVE_BATCH = 8
# Its two attention layers at that prompt: (name, batch, window); every
# layer has softcap 50. The local layer is timed at 2 requests (its
# earlier timings' shape).
GEMMA2_LAYERS = (("local", 2, 4096), ("global", GEMMA2_SERVE_BATCH, None))
# Mixtral-8x7B served at full width: 16 of its 32 layers (all 32 are
# 46.70 B parameters, 93.4 GB in bf16, more than the card holds; 16 are
# 23.48 B = 46.96 GB), every width, the 4096 window and capacity 1.25 as
# published; 4 prompts of 8192 tokens (past the window, so the flash window
# and the ring cache bind), every layer a 4096-slot ring, 64 greedy tokens.
MIXTRAL_CFG = dataclasses.replace(mixtral_8x7b.CONFIG, num_layers=16)
MIXTRAL_SERVE_BATCH = 4
# Its serve_check: capacity E / k = 4.0 drops nothing, so decoding equals
# the teacher-forced forward (the smoke config's 8.0 does the same); bf16
# at the served 16 layers, float32 at 2 (12.6 GB of float32 weights).
MIXTRAL_CHECK = (dataclasses.replace(MIXTRAL_CFG, capacity_factor=4.0), 1,
                 4608)
MIXTRAL_CHECK_FP32_LAYERS = 2
# Jamba-1.5-Large served at full width: its first 5 of 72 layers (mamba,
# mamba_moe, mamba, mamba_moe, attn: layers 0-4 of the published stack,
# attention offset 4, expert offset 1), 48.0 GB in bf16; one period of 8
# layers holds four MoE layers, about 90 GB. Widths, 16 experts top-2 at
# capacity 1.25, d_state 16, d_conv 4 and expand 2 as published; the
# attention layer is NoPE, 64 heads / 8 KV heads, head_dim 128, causal.
# (batch, prompt, cache depth, greedy tokens).
JAMBA_CFG = dataclasses.replace(
    jamba_1_5_large_398b.CONFIG, num_layers=5,
    block_pattern=jamba_1_5_large_398b.CONFIG.block_pattern[:5])
JAMBA_SERVE = (2, 8192, 8224, 32)
# Its serve_check (capacity E / k = 8.0 drops nothing): bf16 at the served 5
# layers; float32 at layers 3-4 (mamba_moe, attn), about 48 GB of float32
# weights, the depth that fits beside the check's activations.
JAMBA_CHECK = (dataclasses.replace(JAMBA_CFG, capacity_factor=8.0), 1, 1024)
JAMBA_CHECK_FP32 = dataclasses.replace(
    JAMBA_CHECK[0], num_layers=2, block_pattern=JAMBA_CFG.block_pattern[3:5],
    param_dtype="float32", compute_dtype="float32")
# xLSTM-125M whole (12 layers, mLSTM:sLSTM 3:1): 8 prompts of 2048 tokens,
# 64 greedy tokens; serve_check at 2 x 512 in float32 and bf16.
XLSTM_SERVE = (8, 2048, 2048 + 64, 64)
XLSTM_CHECK = (xlstm_125m.CONFIG, 2, 512)
# LLaVA-NeXT-34B at full width, 8 of its 60 layers: 4 requests of 576 patch
# positions (drawn from the seed) and 3520 tokens, 32 greedy tokens.
LLAVA_CFG = dataclasses.replace(llava_next_34b.CONFIG, num_layers=8)
LLAVA_SERVE = (4, 3520, 576 + 3520 + 32, 32)
LLAVA_CHECK = (LLAVA_CFG, 1, 1024)
# MusicGen-large whole (48 layers): 8 requests of 1500 codec tokens (30 s
# of 50 Hz codes), 64 greedy tokens.
MUSICGEN_SERVE = (8, 1500, 1500 + 64, 64)
MUSICGEN_CHECK = (musicgen_large.CONFIG, 2, 512)
# One MoE layer at full width held on the card: tokens of one request.
MOE_CHECK_TOKENS = 512
MOE_ROW_RTOL = 2e-2   # bf16, rtol + MOE_ROW_ATOL x each token row's RMS
MOE_ROW_ATOL = 2e-2
# Sequence of the wgmma flash design's timed shape at head_dim 16 and 32
# (bf16, q [4, 8, S, D], k/v [4, 4, S, D], causal).
SMALL_D_SEQ = 4096
# A key tile of the wgmma design at head_dim 256: the faulty plain version
# at Gemma2's layers leaves one such tile out.
WGMMA_D256_TILE = 64
# End-to-end check: the JAX package's own model tolerances
# (tests/test_models_smoke.py): prefill 2e-2, decode 3e-2, rtol = atol.
# (config, batch, prompt): Qwen2-0.5B's, and Gemma2-2B's with a prompt
# longer than its window, so the local layers' window and ring bind.
CHECK_STEPS = 8
SERVE_CHECKS = ((qwen2_0_5b.CONFIG, 2, 512), (gemma2_2b.CONFIG, 1, 4608))
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

# The design phase: repro_torch.paper.scenario's instance (roofnet_like
# seed 0, the 10 lowest-degree agents, kappa 94.47 MB). Supports and routed
# tau of the schemes whose support does not depend on where Adam ends, as
# the JAX designer gives them on the CPU with x64 on (SCA's is printed
# beside the port's, not held: it goes through Adam, whose trajectory is
# chaotic in the last bit):
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c "from repro import compat
#   compat.ensure_x64(); from benchmarks.common import *
#   from repro.core import design; _, ov, cats = paper_scenario()
#   for s in ('clique', 'ring', 'prim', 'fmmd-wp', 'sca'):
#       o = design(s, cats, KAPPA, NUM_AGENTS, overlay=ov, iterations=12,
#                  constants=CONSTANTS)
#       print(s, repr(o.tau), repr(o.rho), o.design.activated_links)"
JAX_DESIGN_LINKS = {
    "clique": tuple((i, j) for i in range(10) for j in range(i + 1, 10)),
    "ring": ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8),
             (8, 9), (0, 9)),
    "prim": ((0, 8), (1, 5), (2, 5), (3, 4), (3, 7), (3, 8), (5, 8), (6, 8),
             (8, 9)),
    "fmmd-wp": ((0, 9), (1, 2), (1, 4), (1, 6), (2, 5), (3, 4), (3, 5),
                (3, 7), (4, 7), (6, 9), (7, 8), (8, 9)),
}
JAX_DESIGN_TAU = {
    "clique": 6801.84, "ring": 1511.52, "prim": 1511.52, "fmmd-wp": 755.76,
}
JAX_DESIGN_SCA = {"links": 21, "tau": 3023.04, "rho": 0.704769947735897}
FULL_WIDTH_AGENTS = 10    # Qwen2-0.5B trained over FMMD-WP's W
# The launcher's step (phase train_launch): Qwen2-0.5B's TRAIN_CONFIG
# (data_dp) at microbatch 2, 8 agents x 2 sequences x 512 tokens.
TRAIN_LAUNCH_SHAPE = ShapeConfig("train_512", 512, 16, "train")
TRAIN_LAUNCH_AGENTS = 8
TRAIN_LAUNCH_STEPS = 3    # timed, after 1 warm-up step
# The modelled fabric its W is designed on: one ring of agents whose links
# carry 450e9 B/s each way (an H100's NVLink, NVIDIA's data sheet); a
# uniform ring's W does not depend on the figure (every tau scales with
# it). The cross-pod figure is unused with one pod.
# The launcher's mesh paths at world size 1 over NCCL (train_mesh,
# serve_mesh): Qwen2-0.5B, data_dp, 1 agent x 2 x 512 tokens, 1 warm-up +
# 2 timed steps; 4 prompts of 8192 tokens, caches 8256 deep, 16 greedy
# decode steps.
TRAIN_MESH_SHAPE = ShapeConfig("train_mesh_512", 512, 2, "train")
TRAIN_MESH_STEPS = 2
SERVE_MESH = (4, 8192, 8256, 16)
MESH_INIT_TIMEOUT_S = 120
FABRIC_LINK_BW = 450e9
FABRIC_CROSS_POD_BW = 50e9
EIGH_M = 1000
# The elastic phase (phase_elastic): examples/elastic_failover.py at full
# width. Qwen2-0.5B x 8 agents on roofnet_like(seed=0)'s 8 lowest-degree
# nodes, 1 x 512 tokens an agent, lr 0.05; the design service (FMMD-P, 12
# iterations, the torch pricing engine on the card) re-designs W through
# the example's five events, the second during a pricing outage; 1 warm-up
# and 2 timed steps at each membership (the example trains 40).
ELASTIC_AGENTS = 8
ELASTIC_STEPS = 2
ELASTIC_SEQ = 512
ELASTIC_LR = 0.05
ELASTIC_OUTAGE_AT = 2.0
ELASTIC_TOPK = 0.01
# The same stream through the JAX package's service on the CPU (engine
# "batched") at the same kappa (one agent's int8 bytes): the start's (m,
# tau), then per event (kind, decision, tier, m, retries, faults, tau, the
# makespans of its pricing calls in order):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import jax
#   from repro.configs import qwen2_0_5b as q; from repro.models import model
#   from repro.net import build_overlay, lowest_degree_nodes, roofnet_like
#   from repro.runtime import design_service as ds
#   from repro.runtime.compression import compressed_kappa
#   from repro.runtime.events import AgentJoin, AgentLeave, LinkStateChange
#   from repro.runtime.faultinject import FaultInjector, FaultPlan
#   kappa = compressed_kappa(jax.eval_shape(
#       lambda: model.init(q.CONFIG, jax.random.key(0))), 'int8')
#   u = roofnet_like(seed=0); ov = build_overlay(u, lowest_degree_nodes(u, 8))
#   svc = ds.DesignService(ov, kappa, ds.ServiceConfig(design_iterations=12))
#   worst = sorted(svc._binc.edges)[:3]
#   free = next(n for n in sorted(u.graph.nodes) if n not in set(ov.agents))
#   priced, sim = [], ds.simulate
#   def rec(*a, **k): r = sim(*a, **k); priced.append(r.makespan); return r
#   ds.simulate = rec; print(kappa, svc.num_agents, repr(svc.tau))
#   for ev in [LinkStateChange(1.0, {e: 0.3 for e in worst}),
#              AgentLeave(2.0, 1), AgentLeave(3.0, 5), AgentJoin(4.0, free),
#              LinkStateChange(5.0, {e: 1.0 for e in worst})]:
#       plan = FaultPlan(0, 1.0, ('raise',))
#       svc.injector = FaultInjector(plan) if ev.time == 2.0 else None
#       priced.clear(); r = svc.process(ev)
#       print((r.event, r.decision, r.tier, svc.num_agents, r.retries,
#              len(r.faults), r.tau, tuple(priced)))"
JAX_ELASTIC_KAPPA = 494032824
JAX_ELASTIC_START = (8, 7904.525184)
JAX_ELASTIC_RECORDS = (
    ("LinkStateChange", "adopt", "normal", 8, 0, 0, 7904.525184,
     (26348.417279999994,)),
    ("AgentLeave", "incumbent-keep", "incumbent-keep", 7, 2, 3, 7904.525184,
     (7904.525184,)),
    ("AgentLeave", "redesign", "normal", 6, 0, 0, 15809.050368,
     (7904.525184, 7904.525184)),
    ("AgentJoin", "redesign", "normal", 7, 0, 0, 13174.20864,
     (15809.050368, 15809.050368)),
    ("LinkStateChange", "adopt", "normal", 7, 0, 0, 7904.525184,
     (11856.787776000001,)),
)
ELASTIC_RTOL = 1e-9


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
    return time_graph_cycle([fn] * reps, replays)


def time_graph_cycle(fns, replays: int = 5) -> float:
    """Mean milliseconds of one call replayed from a CUDA graph that calls
    each of ``fns`` once, in order."""
    for fn in dict.fromkeys(fns):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
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
    return start.elapsed_time(stop) / (len(fns) * replays)


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

    def stacked_no_g(w_np, n, xdt):
        """The mix alone (``g=None``); with neighbours, a plain version
        that drops each agent's last neighbour must be refused."""
        idx_np, wt_np = gossip.neighbor_table(w_np)
        idx = torch.from_numpy(idx_np).to(dev)
        wt = torch.from_numpy(wt_np).to(dev)
        x = randn((w_np.shape[0], n), xdt)
        got = ops.mixing_sgd_combine_stacked(x, idx, wt)
        want = ref.mixing_sgd_combine_stacked_ref(x, idx, wt)
        tol = FP32_TOL if xdt == torch.float32 else BF16_TOL
        r = idx.shape[1]
        name = f"stacked g=None a={w_np.shape[0]} r={r} n={n} x={xdt}"
        err = assert_close(got, want, tol, name)
        case = {"case": name, "tol": tol, "max_abs_err": err, "no_g": True}
        if r:
            faulty = ref.mixing_sgd_combine_stacked_ref(
                x, idx[:, :-1].contiguous(), wt[:, :-1].contiguous())
            agree, fault_err, _ = compare(got, faulty, tol, tol)
            if agree:
                raise AssertionError(
                    f"{name}: the check cannot tell the kernel's output "
                    "from a mix with a neighbour dropped")
            case["dropped_neighbour_refused_max_abs_err"] = fault_err
        results.append(case)

    for w_np in (ring, clique, np.eye(8)):  # R = 2, 7 and 0
        for n in (1 << 20, (1 << 20) + 3):  # odd N: scalar row starts
            stacked_no_g(w_np, n, f32)
            stacked_no_g(w_np, n, bf16)
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


def phase_design(seed: int, seq: int) -> dict:
    """The paper's main path on the card: design W, run D-PSGD with it
    through the kernel, charge every round its routed τ.

    1. the gate, ``fig5_training.run(steps=120, device=None)``: the five
       schemes designed (every weight optimization on the card) and
       trained, every round charged its τ, and the gate's arithmetic; the
       designs held to the JAX designer's supports and τ (``JAX_DESIGN_*``),
       every W valid with ρ < 1; the same design algorithms timed on the
       host for comparison;
    2. the kernel against its plain version over each scheme's plan at
       SMALL_LM's leaf shapes (fp32, 10 agents, up to 9 neighbours, the
       padded slots of irregular tables);
    3. Qwen2-0.5B, unreduced, trained by 10 agents over FMMD-WP's W;
    4. the m = 1000 eigendecomposition, numpy on the host and
       ``torch.linalg.eigh`` in float64 on the card.

    Returns the launch counts of the ``mixing_sgd_combine`` runs and the
    largest errors of its comparisons."""
    _, ov, cats = paper.paper_scenario()
    m = paper.NUM_AGENTS
    leaves = len(tree_leaves(
        model.init(fig5_training.SMALL_LM, 0, device="meta")))
    ops.reset_launch_count()
    t0 = time.perf_counter()
    res = fig5_training.run(steps=paper_gate.STEPS, device=None)
    torch.cuda.synchronize()
    gate_seconds = time.perf_counter() - t0
    gate_launches = ops.launch_count("mixing_sgd_combine")
    want = len(fig5_training.SCHEMES) * paper_gate.STEPS * leaves
    if gate_launches != want:
        raise AssertionError(
            f"gate: {gate_launches} mixing_sgd_combine launches, not "
            f"schemes x steps x leaves = {want}")

    # 1. The designs the gate trained over.
    outcomes = {s: v["outcome"] for s, v in res.items()}
    card = {}
    for s, out in outcomes.items():
        mixing.validate_mixing(out.design.matrix)
        if not out.rho < 1.0:
            raise AssertionError(f"design {s}: rho {out.rho} >= 1")
        card[s] = {
            "links": len(out.design.activated_links), "tau": out.tau,
            "rho": out.rho, "routing": out.routing.method,
            "design_seconds": out.design.design_seconds,
            "routing_seconds": out.routing.solve_seconds,
        }
    for s, links in JAX_DESIGN_LINKS.items():
        got = outcomes[s]
        if got.design.activated_links != links or got.tau != JAX_DESIGN_TAU[s]:
            raise AssertionError(
                f"design {s}: links {got.design.activated_links} tau "
                f"{got.tau!r}, the JAX designer's {links} {JAX_DESIGN_TAU[s]!r}")
    # The design algorithms alone (no routing) on the host, for comparison.
    host_designs = {
        "clique": lambda: clique_design(m, device="cpu"),
        "ring": lambda: ring_design(m, device="cpu"),
        "prim": lambda: prim_design(ov, device="cpu"),
        "fmmd-wp": lambda: fmmd_wp(m, 12, cats, paper.KAPPA, device="cpu"),
        "sca": lambda: sca_design(m, cats, paper.KAPPA, paper.CONSTANTS,
                                  device="cpu"),
    }
    host = {s: make().design_seconds for s, make in host_designs.items()}
    emit(
        "design", agents=m, kappa_bytes=paper.KAPPA, card=card,
        host_design_seconds=host, jax_tau=JAX_DESIGN_TAU,
        sca={"port": card["sca"], "jax": JAX_DESIGN_SCA},
        adam_step_ms=adam_step_ms(),
    )

    # 2. The gate's verdict, and the kernel on the gate's own plans.
    for s, v in res.items():
        v["log"].validate()
        if any(r.tau != v["tau"] for r in v["log"].records):
            raise AssertionError(f"gate {s}: a round not charged its tau")
        if s in JAX_DESIGN_TAU and v["tau"] != JAX_DESIGN_TAU[s]:
            raise AssertionError(f"gate {s}: tau {v['tau']!r}")
        if not all(np.isfinite(v["losses"])):
            raise AssertionError(f"gate {s}: non-finite loss")
    g = paper_gate.gate_numbers(res)
    if not (g["reduction"] >= paper_gate.GATE_REDUCTION
            and g["loss_gap"] <= paper_gate.LOSS_TOL):
        raise AssertionError(f"gate failed on the card: {g}")
    held = gate_plans_check(outcomes, seed)
    emit(
        "gate", steps=paper_gate.STEPS, **g,
        gate_reduction=paper_gate.GATE_REDUCTION,
        loss_tol=paper_gate.LOSS_TOL, seconds=gate_seconds,
        kernel_launches=gate_launches, leaves=leaves,
        schemes={
            s: {"tau": v["tau"], "rho": v["rho"],
                "final_loss": v["final_loss"],
                "time_to_final": v["time_to_final"]}
            for s, v in res.items()
        },
        kernel_check=held,
    )
    del res

    # 3. Full width over the designed W.
    full = full_width_over(outcomes["fmmd-wp"], seed, seq)

    # 4. The eigendecomposition at m = 1000.
    phase_eigh(seed)
    return {
        "gate": gate_launches, "gate_per_step": leaves,
        "gate_max_abs_err": max(h["max_abs_err"] for h in held.values()),
        "full_width": full["launches"],
        "full_width_max_abs_err": full["max_abs_err"],
    }


def gate_plans_check(outcomes: dict, seed: int) -> dict:
    """``mixing_sgd_combine`` against its plain version, with its two fault
    controls, over each scheme's plan (``dpsgd.mixing_plan`` of its W, as
    the gate's training builds it) at every leaf shape of SMALL_LM, fp32,
    lr 0.1 as the gate trains."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    lr = 0.1
    small = tree_paths(model.init(fig5_training.SMALL_LM, 0, device=dev))
    out = {}
    for s, o in outcomes.items():
        plan = dpsgd.mixing_plan(o.design.matrix, dev)
        worst, worst_rel = 0.0, 0.0
        for path, leaf in small:
            scale = leaf_scale(leaf)
            x, g = combine_inputs(gen, plan.num_agents, leaf.numel(),
                                  leaf.dtype, scale, lr)
            err = hold_combine(x, g, plan, lr, scale, f"gate {s} {path}")
            worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        out[s] = {
            "agents": plan.num_agents, "neighbours": plan.idx.shape[1],
            "padded_slots": int((plan.weights == 0).sum()),
            "leaves": len(small), "max_abs_err": worst,
            "max_err_over_scale": worst_rel,
            "rtol": FP32_TOL, "atol_over_scale": FP32_TOL,
        }
    return out


def adam_step_ms(reps: int = 200) -> dict:
    """Milliseconds of one ``weight_opt.adam_step`` at the clique support
    (45 links, the widest the designs optimize), on the card and on the
    host: mean of ``reps`` chained steps after 10 of warm-up."""
    links = JAX_DESIGN_LINKS["clique"]
    out = {}
    for name, dev in (("card", torch.device("cuda")),
                      ("host", torch.device("cpu"))):
        rows = torch.tensor([i for i, _ in links], device=dev)
        cols = torch.tensor([j for _, j in links], device=dev)
        a = torch.full((len(links),), 0.1, dtype=torch.float64, device=dev)
        mom, vel = torch.zeros_like(a), torch.zeros_like(a)
        for t in range(1, reps + 11):
            if t == 11:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            a, mom, vel, _ = weight_opt.adam_step(
                a, mom, vel, float(t), 2560.0, rows, cols, 10, 0.05)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def full_width_over(outcome, seed: int, seq: int) -> dict:
    """Qwen2-0.5B, unreduced, trained by 10 agents over ``outcome``'s W,
    priced ``pricer_for(outcome, "static")``: 1 warm-up + 2 timed steps,
    14 kernel launches a step; then the kernel against its plain version
    over that W's plan at the run's two largest leaves. Memory is freed
    before and after. Returns the launches and the comparisons' largest
    error."""
    cfg = qwen2_0_5b.CONFIG
    m, lr, steps = FULL_WIDTH_AGENTS, 0.05, 3
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    w = outcome.design.matrix
    stream = SyntheticTokenStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, num_agents=m,
                   dirichlet_alpha=0.3, seed=1)
    )
    params = dpsgd.replicate_for_agents(model.init(cfg, seed, device=dev), m)
    leaves = len(tree_leaves(params))
    step_fn = dpsgd.make_dpsgd_step(
        lambda p, b: model.loss(cfg, p, {"tokens": b}, remat=False)[0],
        learning_rate=lr,
    )
    step_ms = []

    def timed_step(p, b, plan_, k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(p, b, plan_, k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    pricer = pricer_for(outcome, "static")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    params, log = train_priced(
        params, timed_step, lambda k: stream.stacked_batch(k, 1, seq), w,
        pricer, steps, design_label=outcome.name, log_every=1,
    )
    launches = ops.launch_count("mixing_sgd_combine")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log.validate()
    if launches != steps * leaves:
        raise AssertionError(
            f"full width: {launches} launches, not {steps} x {leaves}")
    if any(r.tau != outcome.tau for r in log.records):
        raise AssertionError("full width: a round not charged the design's tau")
    if not all(np.isfinite(log.losses)):
        raise AssertionError(f"full width: non-finite loss {log.losses}")
    for path, p in tree_paths(params):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"full width: bad parameters {path}")
    degree = int((np.abs(w - np.diag(np.diag(w))) > 0).sum(axis=1).max())
    largest = sorted(tree_paths(params), key=lambda pl: -pl[1].numel())[:2]
    by_size = [(path, p.numel() // m, p.dtype, leaf_scale(p))
               for path, p in largest]
    del largest
    del params
    torch.cuda.empty_cache()
    # The kernel against its plain version over FMMD-WP's plan (padded
    # irregular table) at the two largest leaves of this run, bf16.
    plan = dpsgd.mixing_plan(w, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    held = []
    for path, n, dtype, scale in by_size:
        x, g = combine_inputs(gen, m, n, dtype, scale, lr)
        err = hold_combine(x, g, plan, lr, scale, f"full width {path}")
        rtol, atol = combine_tolerance(dtype, scale)
        held.append({"leaf": path, "shape": [m, n], "dtype": str(dtype),
                     "neighbours": plan.idx.shape[1], "data_scale": scale,
                     "rtol": rtol, "atol": atol, "max_abs_err": err})
        del x, g
        torch.cuda.empty_cache()
    emit(
        "design_full_width", config=cfg.name, agents=m, design=outcome.name,
        links=len(outcome.design.activated_links), max_degree=degree,
        rho=outcome.rho, tau=outcome.tau, seq_len=seq, per_agent_batch=1,
        lr=lr, leaves=leaves, kernel_launches=launches,
        losses=log.losses, step_ms=step_ms,
        step_ms_mean_timed=float(np.mean(step_ms[1:])),
        peak_memory_gb=peak, kernel_check=held,
    )
    del log, plan
    torch.cuda.empty_cache()
    return {"launches": launches,
            "max_abs_err": max(h["max_abs_err"] for h in held)}


def phase_eigh(seed: int) -> None:
    """FMMD's per-iteration eigendecomposition at m = 1000 (a mixing
    matrix minus J, on a support where each agent is linked to 3 random
    others: mean degree about 6): numpy ``eigh`` on
    the host against ``torch.linalg.eigh`` in float64 on the card, on the
    same matrix; times are the mean of 5 after one warm-up."""
    rng = np.random.default_rng(seed)
    m = EIGH_M
    links = sorted({
        (min(i, j), max(i, j))
        for i in range(m) for j in rng.choice(m, 3, replace=False) if i != j
    })
    a = mixing.matrix_from_weights(
        m, links, rng.uniform(0.02, 0.2, len(links))) - mixing.ideal_matrix(m)
    np.linalg.eigh(a)
    t0 = time.perf_counter()
    for _ in range(5):
        host_vals, _ = np.linalg.eigh(a)
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    card_a = torch.from_numpy(a).cuda()
    card_ms = time_cuda(lambda: torch.linalg.eigh(card_a), reps=5)
    vals, vecs = torch.linalg.eigh(card_a)
    err = float(np.abs(vals.cpu().numpy() - host_vals).max())
    resid = float((card_a @ vecs - vecs * vals).abs().max())
    if not (err <= 1e-10 and resid <= 1e-10):
        raise AssertionError(f"eigh at m={m}: eig err {err}, residual {resid}")
    emit(
        "design_eigh", m=m, links=len(links), host_numpy_ms=host_ms,
        card_torch_ms=card_ms, max_eigenvalue_diff=err,
        card_residual=resid,
    )
    del card_a, vals, vecs
    torch.cuda.empty_cache()


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


def combine_tolerance(dtype: torch.dtype, scale: float) -> tuple[float, float]:
    """(rtol, atol) of ``mixing_sgd_combine`` against its plain version:
    one bf16 ulp in bf16, ``FP32_TOL`` in fp32, atol scaled by the data."""
    if dtype == torch.bfloat16:
        return BF16_ULP_RTOL, BF16_ULP_ATOL * scale
    return FP32_TOL, FP32_TOL * scale


def combine_inputs(gen, a_dim: int, n: int, dtype: torch.dtype,
                   scale: float, lr: float):
    """x ``[a_dim, n]`` of a leaf's dtype and magnitude with every agent's
    row drawn on its own, and g with lr*g of x's order: a wrong row, a
    wrapped offset or a dropped term changes the result by about its whole
    value."""
    x = torch.empty(a_dim, n, dtype=dtype, device="cuda")
    x.normal_(generator=gen).mul_(scale)
    g = torch.empty_like(x).normal_(generator=gen).mul_(scale / lr)
    return x, g


def hold_combine(x, g, plan, lr: float, scale: float, what: str) -> float:
    """The kernel against its plain version on ``(x, g)`` over ``plan``
    (``combine_tolerance``); returns the largest absolute error. The
    comparison must be able to fail: the same output held against the
    plain version of a faulty update (another agent's neighbour rows, the
    gradient term dropped) has to be refused."""
    rtol, atol = combine_tolerance(x.dtype, scale)
    got = ops.mixing_sgd_combine_stacked(x, plan.idx, plan.weights, g, lr=lr)
    want = ref.mixing_sgd_combine_stacked_ref(
        x, plan.idx, plan.weights, g, lr=lr)
    err = assert_close(got, want, rtol, what, atol=atol)
    del want
    for fault, bad_idx, bad_lr in (
        ("wrong neighbour rows", plan.idx.roll(1, dims=0), lr),
        ("gradient term dropped", plan.idx, 0.0),
    ):
        faulty = ref.mixing_sgd_combine_stacked_ref(
            x, bad_idx, plan.weights, g, lr=bad_lr)
        if compare(got, faulty, rtol, atol)[0]:
            raise AssertionError(
                f"{what}: the check cannot tell the kernel's output from "
                f"an update with {fault}")
        del faulty
    return err


def combine_times(x: torch.Tensor, g: torch.Tensor, plan, lr: float) -> dict:
    """``mixing_sgd_combine`` on ``x``, ``g`` ``[A, N]`` over ``plan``: its
    time beside its bound (each input read once, the output written once),
    its plain version's and one dense PyTorch call's."""
    ms = time_cuda(
        lambda: ops.mixing_sgd_combine_stacked(
            x, plan.idx, plan.weights, g, lr=lr), reps=TIMING_REPS)
    plain_ms = time_cuda(
        lambda: ref.mixing_sgd_combine_stacked_ref(
            x, plan.idx, plan.weights, g, lr=lr), reps=TIMING_REPS)
    w_dense = plan.w.to(x.dtype)
    # One PyTorch call for the same function with a dense W: a yardstick
    # only, the port never calls it.
    library_ms = time_cuda(
        lambda: torch.addmm(g, w_dense, x, beta=-lr), reps=TIMING_REPS)
    r = plan.idx.shape[1]
    moved = (x.numel() * x.element_size() + g.numel() * g.element_size()
             + x.numel() * x.element_size()
             + plan.idx.numel() * 4 + plan.weights.numel() * 4)
    flops = x.numel() * (2 * (r + 1) + 1)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "shape": list(x.shape), "dtype": str(x.dtype), "neighbours": r,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "share_of_bound": max(t_bytes, t_ops) / ms,
        "library_ms": library_ms,
        "library_call": "torch.addmm(g, W, x, beta=-lr)",
        "bytes_moved_once": moved, "flops": flops,
    }


def phase_kernels(params, plan, launches, leaves, seed: int) -> dict:
    """The kernel at the two largest leaves the main path gives it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    lr = 0.05
    by_size = sorted(tree_paths(params), key=lambda pl: -pl[1].numel())[:2]
    a_dim = plan.num_agents

    # Copy bandwidth of this card in this run (read + write of 2 GiB).
    src = torch.empty(1 << 30, dtype=torch.int16, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_cuda(lambda: dst.copy_(src), reps=TIMING_REPS)
    copy_bytes_per_s = 2 * src.numel() * src.element_size() / (copy_ms * 1e-3)
    del src, dst

    shapes = []
    for path, leaf in by_size:
        scale = leaf_scale(leaf)
        x, g = combine_inputs(gen, a_dim, leaf.numel() // a_dim, leaf.dtype,
                              scale, lr)
        w_dense = plan.w.to(x.dtype)
        rtol, atol = combine_tolerance(x.dtype, scale)
        err = hold_combine(x, g, plan, lr, scale, f"main-path shape {path}")
        timed = combine_times(x, g, plan, lr)
        unfused_ms = time_cuda(
            lambda: torch.einsum("ab,bn->an", w_dense, x) - lr * g,
            reps=TIMING_REPS,
        )
        moved = timed["bytes_moved_once"]
        shapes.append({
            "leaf": path, **timed, "data_scale": scale, "rtol": rtol,
            "atol": atol, "max_abs_err": err, "unfused_ms": unfused_ms,
            "copy_bound_ms": moved / copy_bytes_per_s * 1e3,
            "achieved_bytes_per_s": moved / (timed["ms"] * 1e-3),
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
# The launcher's training step (launch/train.py)
# ---------------------------------------------------------------------------


def hold_no_g(path: str, x: torch.Tensor, plan, scale: float) -> dict:
    """The sparse gossip (``gossip.mix_sparse``: the kernel's ``g=None``
    form) on one leaf ``x [A, ...]`` against its plain version at
    ``combine_tolerance`` for the leaf's ``scale``. The comparison must be
    able to fail: a mix with a dropped neighbour and one with another
    agent's neighbour rows, held against the same output at the same
    limit, have to be refused."""
    a = x.shape[0]
    flat = x.reshape(a, -1)
    rtol, atol = combine_tolerance(x.dtype, scale)
    got = gossip.mix_sparse({"leaf": x}, plan.idx, plan.weights)["leaf"]
    got = got.reshape(a, -1)
    want = ref.mixing_sgd_combine_stacked_ref(flat, plan.idx, plan.weights)
    err = assert_close(got, want, rtol, f"g=None at {path}", atol=atol)
    del want
    # Each agent's first neighbour dropped (the table pads short rows at
    # their end with zero weights, so the first column is a real one).
    dropped = plan.weights.clone()
    dropped[:, 1] = 0.0
    refused = {}
    for fault, idx, wt in (
        ("dropped_neighbour", plan.idx, dropped),
        ("wrong_neighbour_rows", plan.idx.roll(1, dims=0), plan.weights),
    ):
        faulty = ref.mixing_sgd_combine_stacked_ref(flat, idx, wt)
        agree, _, worst = compare(got, faulty, rtol, atol)
        if agree:
            raise AssertionError(
                f"g=None at {path}: the check cannot tell the kernel's "
                f"output from a mix with a {fault}")
        refused[fault] = worst
        del faulty
    return {"leaf": path, "shape": list(x.shape), "dtype": str(x.dtype),
            "data_scale": scale, "rtol": rtol, "atol": atol,
            "max_abs_err": err, "refused_err_over_limit": refused}


def no_g_every_leaf(params, plan, seed: int) -> dict:
    """``hold_no_g`` on every leaf of the run's parameters, each agent
    pushed apart by noise of the leaf's scale: after a few steps from an
    identical start the agents still agree to far below a bf16 ulp, which
    would hide a wrong row."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    held = []
    for path, p in tree_paths(params):
        scale = leaf_scale(p)
        x = torch.empty_like(p).normal_(generator=gen).mul_(scale).add_(p)
        held.append(hold_no_g(path, x, plan, scale))
        del x
        torch.cuda.empty_cache()
    return {
        "leaves": held,
        "max_abs_err": max(h["max_abs_err"] for h in held),
        "fewest_refused_err_over_limit": min(
            v for h in held for v in h["refused_err_over_limit"].values()),
    }


def no_g_times(leaf: torch.Tensor, plan) -> dict:
    """The kernel's ``g=None`` form at one leaf of the run, timed beside
    its bound, its plain version and one dense PyTorch product."""
    x = leaf.reshape(leaf.shape[0], -1)
    w_dense = plan.w.to(x.dtype)
    ms = time_cuda(
        lambda: ops.mixing_sgd_combine_stacked(x, plan.idx, plan.weights),
        reps=TIMING_REPS)
    plain_ms = time_cuda(
        lambda: ref.mixing_sgd_combine_stacked_ref(x, plan.idx, plan.weights),
        reps=5)
    # One PyTorch call for the same mix with a dense W: a yardstick only.
    library_ms = time_cuda(lambda: torch.mm(w_dense, x), reps=TIMING_REPS)
    r = plan.idx.shape[1]
    moved = (2 * x.numel() * x.element_size()      # x read once, out written
             + plan.idx.numel() * 4 + plan.weights.numel() * 4)
    flops = x.numel() * 2 * (r + 1)
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "form": "g=None", "shape": list(x.shape), "dtype": str(x.dtype),
        "neighbours": r, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "library_call": "torch.mm(W, x)",
        "bytes_moved_once": moved, "flops": flops,
        "achieved_bytes_per_s": moved / (ms * 1e-3),
    }


def smoke_modes_check(seed: int, card=None) -> dict:
    """Two steps of the launcher at SMOKE_CONFIG on the card (``card``;
    None is CUDA) in every gossip mode, against the same steps on the CPU
    (the kernel's plain version there): losses to rtol 1e-4 and parameters
    to atol 1e-4. The second step's loss follows the first mix. The
    comparison must be able to fail: the card's parameters in each mode,
    held against the CPU's in every mode that mixes by another matrix
    (the ring, J or none), have to be refused."""
    cfg = qwen2_0_5b.SMOKE_CONFIG
    m, steps, tol = 4, 2, 1e-4
    shape = ShapeConfig("smoke", 16, 2 * m, "train")
    ring, j = ring_matrix(m), mixing.ideal_matrix(m)
    modes = {"dense": (ring, "ring"), "allreduce": (j, "J"),
             "none": (ring, "none"), "sparse": (ring, "ring")}
    stream = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, num_agents=m, seed=1))
    out, params = {}, {}
    for mode, (w, _) in modes.items():
        tcfg = TrainConfig(agent_layout="data", gossip=mode, microbatch=2,
                           learning_rate=0.05)
        arts = {
            d: train.build_train_artifacts(
                cfg, tcfg, shape, launch_mesh.make_test_mesh((m, 1)), w,
                device=d)
            for d in ("cpu", card)
        }
        batch_fn = make_batch_fn(stream, arts["cpu"].batch_shapes,
                                 cfg.vocab_size)
        s_cpu = arts["cpu"].init_state(seed)
        s_card = tree_map(
            lambda t: t.to(card or "cuda") if torch.is_tensor(t) else t,
            s_cpu)
        losses = []
        for k in range(steps):
            s_cpu, m_cpu = arts["cpu"].step_fn(s_cpu, batch_fn(k))
            s_card, m_card = arts[card].step_fn(s_card, batch_fn(k))
            loss_cpu, loss_card = float(m_cpu["loss"]), float(m_card["loss"])
            if not abs(loss_card - loss_cpu) <= tol * abs(loss_cpu):
                raise AssertionError(
                    f"smoke {mode} step {k}: loss {loss_card} on the card, "
                    f"{loss_cpu} on the CPU")
            losses.append(loss_card)
        params[mode] = (tree_leaves(s_card["params"]),
                        tree_leaves(s_cpu["params"]))
        diff = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(*params[mode]))
        if not diff <= tol:
            raise AssertionError(
                f"smoke {mode}: parameters {diff} apart from the CPU's")
        out[mode] = {"resolved": arts[card].gossip, "losses": losses,
                     "max_abs_param_diff": diff}
    for mode, (_, mixes) in modes.items():
        refused = {}
        for other, (_, other_mixes) in modes.items():
            if other_mixes == mixes:
                continue
            diff = max(float((a.cpu() - b).abs().max())
                       for a, b in zip(params[mode][0], params[other][1]))
            if diff <= tol:
                raise AssertionError(
                    f"smoke {mode}: the check cannot tell the card's "
                    f"parameters from the CPU's in mode {other}")
            refused[other] = diff
        out[mode]["refused_max_abs_param_diff"] = refused
    return out


def checkpoint_round_trip(seed: int) -> dict:
    """SMOKE_CONFIG, 8 agents: one step, an ``AsyncCheckpointer`` save,
    a restore onto 7 agents (elastic remap) bitwise the saved leaves, and
    one more step over a 7-agent fabric W."""
    cfg = qwen2_0_5b.SMOKE_CONFIG
    tcfg = TrainConfig(agent_layout="data_dp", microbatch=2)
    kappa = float(model.parameter_count(cfg) * 4)
    arts, batches = {}, {}
    for m in (8, 7):
        w, _ = fabric.design_mixing_matrix(
            m, 1, kappa, link_bw=FABRIC_LINK_BW,
            cross_pod_bw=FABRIC_CROSS_POD_BW)
        arts[m] = train.build_train_artifacts(
            cfg, tcfg, ShapeConfig("smoke", 16, 2 * m, "train"),
            launch_mesh.make_test_mesh((m, 1)), w)
        stream = SyntheticTokenStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=16, num_agents=m, seed=1))
        batches[m] = make_batch_fn(stream, arts[m].batch_shapes,
                                   cfg.vocab_size)
    state, _ = arts[8].step_fn(arts[8].init_state(seed), batches[8](0))
    with tempfile.TemporaryDirectory() as d:
        saver = AsyncCheckpointer(d, keep=2)
        saver.save(state["step"], state)
        saver.close()
        restored, step = restore(d, arts[7].state_shapes, num_agents=7)
    for (path, got), want in zip(tree_paths(restored["params"]),
                                 tree_leaves(state["params"])):
        if got.dtype != want.dtype or not torch.equal(got, want[:7]):
            raise AssertionError(f"restored {path} is not the saved leaf")
    for got, want in zip(tree_leaves(restored["opt"]),
                         tree_leaves(state["opt"])):
        if not torch.equal(got, want[:7]):
            raise AssertionError("restored momentum is not the saved one")
    if step != state["step"] or restored["step"] != state["step"]:
        raise AssertionError(f"restored step {step}, saved {state['step']}")
    state7, met = arts[7].step_fn(restored, batches[7](1))
    loss = float(met["loss"])
    if not np.isfinite(loss) or state7["step"] != step + 1:
        raise AssertionError(f"the restored run's step: loss {loss}")
    return {"agents_saved": 8, "agents_restored": 7, "step": step,
            "gossip_8": arts[8].gossip, "gossip_7": arts[7].gossip,
            "loss_after_restore": loss, "restored_bitwise": True}


def phase_train_launch(seed: int) -> dict:
    """The launcher's D-PSGD step (``launch.train.build_train_artifacts``)
    for Qwen2-0.5B, unreduced and bf16, in its ``TRAIN_CONFIG`` layout
    (``data_dp``) at microbatch 2: 8 agents x 2 sequences x 512 tokens a
    step (k = 2, mb = 1), W designed by ``launch.fabric`` (FMMD-WP on the
    card, kappa one agent's bf16 bytes) and resolved to the ``sparse``
    gossip, batches through ``make_batch_fn`` and ``Prefetcher``: 1
    warm-up + 3 timed steps, exactly 14 launches of ``mixing_sgd_combine``
    a step. Then the sparse gossip (the kernel's ``g=None`` form) held on
    every leaf of the run's parameters with two faulty mixes refused at
    each, and timed at the embedding leaf; the smoke model in every mode
    against the CPU; and a checkpoint round trip onto 7 agents."""
    cfg = qwen2_0_5b.CONFIG
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(get_train_config("qwen2-0.5b"), microbatch=2)
    m = TRAIN_LAUNCH_AGENTS
    n_params = model.parameter_count(cfg)
    kappa = float(n_params * compat.dtype_of(cfg.param_dtype).itemsize)
    t0 = time.perf_counter()
    w, design = fabric.design_mixing_matrix(
        m, 1, kappa, link_bw=FABRIC_LINK_BW, cross_pod_bw=FABRIC_CROSS_POD_BW)
    design_seconds = time.perf_counter() - t0
    art = train.build_train_artifacts(
        cfg, tcfg, TRAIN_LAUNCH_SHAPE, launch_mesh.make_test_mesh((m, 1)), w)
    if art.gossip != "sparse" or art.num_agents != m:
        raise AssertionError(
            f"train_launch: {art.num_agents} agents, gossip {art.gossip!r}, "
            "not 8 and 'sparse'")
    plan = dpsgd.mixing_plan(art.mixing_matrix, dev)
    leaves = len(tree_leaves(art.state_shapes["params"]))
    _, k, mb, s1 = art.batch_shapes["tokens"].shape
    tokens_per_step = m * k * mb * (s1 - 1)
    stream = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s1 - 1, num_agents=m,
        dirichlet_alpha=0.3, seed=1))
    batch_fn = make_batch_fn(stream, art.batch_shapes, cfg.vocab_size)
    state = art.init_state(seed)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    prefetch = Prefetcher(batch_fn, dev)
    steps = []
    for _ in range(1 + TRAIN_LAUNCH_STEPS):
        k_step, batch = next(prefetch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = art.step_fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        steps.append({"step": k_step, "loss": float(metrics["loss"]),
                      "lr": metrics["lr"], "step_ms": ms})
    prefetch.close()
    launches = ops.launch_count("mixing_sgd_combine")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != (1 + TRAIN_LAUNCH_STEPS) * leaves:
        raise AssertionError(
            f"train_launch: {launches} mixing_sgd_combine launches, not "
            f"{1 + TRAIN_LAUNCH_STEPS} steps x {leaves} leaves")
    if not all(np.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"train_launch: non-finite loss {steps}")
    if state["step"] != 1 + TRAIN_LAUNCH_STEPS:
        raise AssertionError(f"train_launch: step counter {state['step']}")
    for path, p in tree_paths(state["params"]):
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"train_launch: non-finite {path}")
    step_ms_mean = float(np.mean([s["step_ms"] for s in steps[1:]]))

    no_g_held = no_g_every_leaf(state["params"], plan, seed)
    no_g = no_g_times(state["params"]["embed"]["table"], plan)
    no_g["max_abs_err"] = next(h["max_abs_err"] for h in no_g_held["leaves"]
                               if h["leaf"] == "embed/table")
    mix_ms_per_step = time_cuda(
        lambda: gossip.mix_sparse(state["params"], plan.idx, plan.weights),
        reps=5)
    mix_bytes = sum(2 * p.numel() * p.element_size()
                    for p in tree_leaves(state["params"]))
    del state
    torch.cuda.empty_cache()
    smoke = smoke_modes_check(seed)
    ckpt = checkpoint_round_trip(seed)
    out = {
        "config": cfg.name, "parameters_per_agent": n_params, "agents": m,
        "leaves": leaves, "layout": tcfg.agent_layout, "remat": tcfg.remat,
        "microbatches": k, "microbatch_size": mb, "seq_len": s1 - 1,
        "tokens_per_step": tokens_per_step, "param_dtype": cfg.param_dtype,
        "gossip": art.gossip, "neighbours": int(plan.idx.shape[1]),
        "activated_links": len(design.activated_links), "rho": design.rho,
        "design_seconds_on_card": design_seconds,
        "fabric": {"link_bw": FABRIC_LINK_BW, "kappa_bytes": kappa},
        "warmup_steps": 1, "timed_steps": TRAIN_LAUNCH_STEPS, "steps": steps,
        "step_ms_mean_timed": step_ms_mean,
        "tokens_per_s": tokens_per_step / (step_ms_mean * 1e-3),
        "peak_memory_gb": peak_gb, "kernel_launches": launches,
        "launches_per_step": leaves,
        "no_g_every_leaf": no_g_held,
        "no_g_at_embedding_leaf": no_g,
        "mix_ms_per_step": mix_ms_per_step,
        "mix_bound_ms_per_step": mix_bytes / PEAK_BYTES_PER_S * 1e3,
        "smoke_modes": smoke, "checkpoint": ckpt,
    }
    emit("train_launch", **out)
    return {**out, "mixing_matrix": art.mixing_matrix}


# ---------------------------------------------------------------------------
# D-PSGD across ranks (launch/mesh.py, launch/sharding.py, core/gossip.py):
# the mesh paths at world size 1 over NCCL, the per-agent combine
# ---------------------------------------------------------------------------


def per_agent_flat_combine(seed: int, w: np.ndarray) -> dict:
    """The kernel's per-agent form without momentum (what
    ``gossip.mix_sparse_p2p`` launches on each rank) at the flat gossip
    buffer of ``mix_sparse_flat``: all of Qwen2-0.5B raveled, bf16, x[N]
    with the received shards recv[R, N], R the largest in-degree of
    ``train_launch``'s W and that agent's row of W. Held against its plain
    version at one bf16 ulp and the data-scaled limit, with a control that
    drops one received row refused; timed over 20 launches beside its
    byte bound, the plain version and one ``torch.addmm``."""
    n = model.parameter_count(qwen2_0_5b.CONFIG)
    idx, table = gossip.neighbor_table(w)
    degree = (np.abs(table[:, 1:]) > 0).sum(axis=1)
    agent = int(degree.argmax())
    r = int(degree[agent])
    nbrs = [int(j) for j in idx[agent, :r]]
    weights = [w[agent, agent]] + [w[agent, j] for j in nbrs]
    out = hold_per_agent_combine(seed + 21, n, weights, "per-agent flat "
                                 "combine")
    out["agent"] = agent
    emit("per_agent_flat_combine", **out)
    return out


def hold_per_agent_combine(seed: int, n: int, w_row, what: str) -> dict:
    """The per-agent form without momentum at x[N] bf16 with R = len(w_row)
    - 1 received rows recv[R, N] and the weights ``w_row`` (its own first),
    data drawn from ``seed``: held against its plain version at one bf16
    ulp and the data-scaled limit, with a control that drops one received
    row refused; timed over 20 launches beside its byte bound, the plain
    version and one ``torch.addmm``."""
    r = len(w_row) - 1
    weights = torch.tensor(w_row, dtype=torch.float32, device="cuda")
    scale = 0.02
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    x.normal_(generator=gen).mul_(scale)
    recv = torch.empty(r, n, dtype=torch.bfloat16, device="cuda")
    recv.normal_(generator=gen).mul_(scale)
    rtol, atol = combine_tolerance(torch.bfloat16, scale)
    got = ops.mixing_sgd_combine(x, recv, weights)
    want = ref.mixing_sgd_combine_ref(x, recv, weights)
    err = assert_close(got, want, rtol, what, atol=atol)
    del want
    dropped = weights.clone()
    dropped[1] = 0.0
    faulty = ref.mixing_sgd_combine_ref(x, recv, dropped)
    agree, _, refused = compare(got, faulty, rtol, atol)
    if agree:
        raise AssertionError(
            f"{what}: the check cannot tell the kernel's output from a mix "
            "with a received row dropped")
    del faulty, got
    torch.cuda.empty_cache()
    ms = time_cuda(lambda: ops.mixing_sgd_combine(x, recv, weights),
                   reps=TIMING_REPS)
    plain_ms = time_cuda(
        lambda: ref.mixing_sgd_combine_ref(x, recv, weights), reps=3)
    w_bf = weights.to(torch.bfloat16)
    x_row = x[None]
    w0 = float(weights[0])
    library_ms = time_cuda(
        lambda: torch.addmm(x_row, w_bf[None, 1:], recv, beta=w0),
        reps=TIMING_REPS)
    moved = (r + 2) * n * x.element_size() + weights.numel() * 4
    flops = 2 * (r + 1) * n
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    out = {
        "form": "per-agent, momentum=None", "n": n, "neighbours": r,
        "dtype": "torch.bfloat16", "data_scale": scale,
        "rtol": rtol, "atol": atol, "max_abs_err": err,
        "dropped_row_refused_err_over_limit": refused,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "library_call": "torch.addmm(x, W_row, recv, beta=W_ii)",
        "bytes_moved_once": moved, "flops": flops,
        "achieved_bytes_per_s": moved / (ms * 1e-3),
    }
    del x, recv
    torch.cuda.empty_cache()
    return out


def phase_mesh_init():
    """A (1, 1) ``DeviceMesh`` ("data", "model") over NCCL at world size 1,
    from a ``file://`` rendezvous in a fresh temporary directory."""
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.perf_counter()
    mesh = launch_mesh.init_mesh(
        (1, 1), ("data", "model"),
        init_method=f"file://{os.path.join(rendezvous, 'store')}", rank=0,
        world_size=1,
        timeout=datetime.timedelta(seconds=MESH_INIT_TIMEOUT_S))
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        raise AssertionError(f"the mesh's process group is {backend}")
    emit("mesh_init", seconds=time.perf_counter() - t0, backend=backend,
         world_size=torch.distributed.get_world_size(),
         axes=list(mesh.mesh_dim_names), shape=list(mesh.mesh.shape))
    return mesh


def phase_train_mesh(seed: int, mesh) -> dict:
    """The launcher's mesh path (``build_train_artifacts`` on the
    ``DeviceMesh``) for Qwen2-0.5B, unreduced, ``data_dp`` at microbatch 2,
    1 agent x 2 x 512 tokens: 1 warm-up + 2 timed steps, the batch cut to
    the rank's part by ``sharding.shard_tree``, the gradients summed over
    the ``model`` group (a real NCCL all-reduce, counted by a spy). The
    parameters, momentum and losses must equal bitwise the one-card
    launcher's steps on a ``Mesh((1, 1))`` description from the same state
    and batches. Then the flat gossip (``gossip.mix_sparse_flat``, one
    agent, R = 0) on the run's parameters: exactly one launch of the
    per-agent combine, its output bitwise the parameters (W = [1])."""
    cfg = qwen2_0_5b.CONFIG
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(get_train_config("qwen2-0.5b"), microbatch=2)
    arts = {
        "mesh": train.build_train_artifacts(cfg, tcfg, TRAIN_MESH_SHAPE,
                                            mesh),
        "one_card": train.build_train_artifacts(
            cfg, tcfg, TRAIN_MESH_SHAPE, launch_mesh.make_test_mesh((1, 1))),
    }
    stream = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_MESH_SHAPE.seq_len,
        num_agents=1, dirichlet_alpha=0.3, seed=1))
    batch_fn = make_batch_fn(stream, arts["mesh"].batch_shapes,
                             cfg.vocab_size)
    batches = [batch_fn(k) for k in range(1 + TRAIN_MESH_STEPS)]
    reduced = []
    real_reduce = train._reduce_gradients

    def spy(grads, group):
        reduced.append(torch.distributed.get_backend(group))
        real_reduce(grads, group)

    train._reduce_gradients = spy
    runs = {}
    for name, art in arts.items():
        state = art.init_state(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_count()
        steps = []
        for batch in batches:
            if name == "mesh":
                batch = sharding.shard_tree(batch, art.batch_specs, mesh)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = art.step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"loss": loss,
                          "step_ms": (time.perf_counter() - t) * 1e3})
        runs[name] = {"state": state, "steps": steps,
                      "launches": ops.launch_count("mixing_sgd_combine"),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    train._reduce_gradients = real_reduce
    if reduced != ["nccl"] * len(batches):
        raise AssertionError(
            f"train_mesh: model-group gradient reductions {reduced}, not "
            f"{len(batches)} over NCCL")
    mine, one = runs["mesh"], runs["one_card"]
    if [s["loss"] for s in mine["steps"]] != [s["loss"] for s in
                                                 one["steps"]]:
        raise AssertionError(
            f"train_mesh: losses {mine['steps']} vs one card {one['steps']}")
    for part in ("params", "opt"):
        for (path, a), b in zip(tree_paths(mine["state"][part]),
                                tree_leaves(one["state"][part])):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(
                    f"train_mesh: {part}/{path} is not bitwise the one-card "
                    "launcher's")
    if mine["state"]["step"] != 1 + TRAIN_MESH_STEPS:
        raise AssertionError(f"train_mesh: step {mine['state']['step']}")
    if mine["launches"] or one["launches"]:
        raise AssertionError("train_mesh: one agent launched a gossip")
    params, one_steps = mine["state"]["params"], one["steps"]
    del runs, one
    torch.cuda.empty_cache()
    ops.reset_launch_count()
    schedule = gossip.build_schedule(np.eye(1))
    mixed = gossip.mix_sparse_flat(params, schedule, mesh, ("data",))
    flat_launches = ops.launch_count("mixing_sgd_combine")
    if flat_launches != 1:
        raise AssertionError(
            f"mix_sparse_flat launched the combine {flat_launches} times")
    for (path, a), b in zip(tree_paths(mixed), tree_leaves(params)):
        if not torch.equal(a, b):
            raise AssertionError(f"mix_sparse_flat at W = [1] changed {path}")
    timed = [s["step_ms"] for s in mine["steps"][1:]]
    k, mb, s1 = arts["mesh"].batch_shapes["tokens"].shape[1:]
    out = {
        "config": cfg.name, "layout": tcfg.agent_layout, "mesh": [1, 1],
        "backend": "nccl", "gossip": arts["mesh"].gossip,
        "microbatches": k, "microbatch_size": mb, "seq_len": s1 - 1,
        "steps": mine["steps"], "one_card_steps": one_steps,
        "step_ms_mean_timed": float(np.mean(timed)),
        "tokens_per_s": k * mb * (s1 - 1) / (np.mean(timed) * 1e-3),
        "peak_memory_gb": mine["peak_gb"], "model_reductions": reduced,
        "bitwise_one_card": True,
        "flat_gossip_launches": flat_launches,
        "flat_gossip_bitwise": True,
    }
    emit("train_mesh", **out)
    del params, mixed
    torch.cuda.empty_cache()
    return out
def greedy(prefill_fn, step_fn, params, inputs, steps: int):
    """Prefill, then ``steps`` greedy decode steps: ``(logits of every
    call, tokens fed, prefill seconds, decode step ms)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, inputs)
    token = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    outs, tokens, step_ms = [logits], [token], []
    for _ in range(steps):
        t = time.perf_counter()
        logits, caches = step_fn(params, caches, token)
        token = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(logits)
        tokens.append(token)
    del caches
    return outs, torch.cat(tokens, dim=1), prefill_s, step_ms


def phase_serve_mesh(seed: int, mesh) -> dict:
    """The serve mesh path (``build_serve_artifacts(..., mesh=mesh)``, the
    batch over "data", ``model`` = 1) at world size 1: Qwen2-0.5B at full
    width, 4 prompts of 8192 tokens cut to the rank's rows by
    ``sharding.shard_tree``, caches 8256 deep, 16 greedy decode steps.
    Counters set to 0 just before and read just after: 24 ``wgmma`` flash
    launches in the prefill and 24 x 16 ``mma`` decode launches. Every
    logit and token must equal bitwise those of the one-card path
    (``build_serve_artifacts(cfg, shape)``) on the same weights."""
    cfg = qwen2_0_5b.CONFIG
    b, prompt, max_len, steps = SERVE_MESH
    arts = {
        key: serve.build_serve_artifacts(
            cfg, ShapeConfig("serve_mesh", max_len, b, kind), mesh=m)
        for key, kind, m in (("prefill", "prefill", mesh),
                             ("decode", "decode", mesh),
                             ("one_card", "prefill", None))
    }
    params = serve_params(cfg, seed)
    inputs = {"tokens": serve_prompts(cfg, b, seed, prompt)}
    mine_inputs = sharding.shard_tree(inputs, arts["prefill"].input_specs,
                                      mesh)
    layers = attention_layers(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    logits, tokens, prefill_s, step_ms = greedy(
        arts["prefill"].prefill_fn, arts["decode"].step_fn, params,
        mine_inputs, steps)
    launches = {name: ops.launch_count(name) for name in KERNELS}
    flash_designs = flash_mod.launch_count_by_design()
    decode_designs = decode_mod.launch_count_by_design()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": layers, "decode_attention": layers * steps,
            "mixing_sgd_combine": 0}
    if launches != want:
        raise AssertionError(f"serve_mesh launches {launches}, not {want}")
    if flash_designs != launches_by_design(flash_mod.DESIGNS, "wgmma",
                                           layers) or \
            decode_designs != launches_by_design(decode_mod.DESIGNS, "mma",
                                                 layers * steps):
        raise AssertionError(
            f"serve_mesh designs {flash_designs} / {decode_designs}")
    one_logits, one_tokens, one_prefill_s, one_step_ms = greedy(
        arts["one_card"].prefill_fn, arts["one_card"].step_fn, params,
        inputs, steps)
    if not torch.equal(tokens, one_tokens):
        raise AssertionError("serve_mesh: tokens differ from the one card's")
    for i, (a, c) in enumerate(zip(logits, one_logits)):
        if not torch.equal(a, c):
            raise AssertionError(
                f"serve_mesh: call {i}'s logits differ from the one card's")
    if not bool(torch.isfinite(logits[-1]).all()) or tokens.shape != (
            b, steps + 1):
        raise AssertionError("serve_mesh: bad output")
    out = {
        "config": cfg.name, "mesh": [1, 1], "backend": "nccl", "batch": b,
        "rows_here": int(mine_inputs["tokens"].shape[0]), "prompt": prompt,
        "max_len": max_len, "decode_steps": steps,
        "prefill_seconds": prefill_s,
        "prefill_tokens_per_s": b * prompt / prefill_s,
        "decode_step_ms": step_ms,
        "decode_step_ms_mean_after_first": float(np.mean(step_ms[1:])),
        "one_card_prefill_seconds": one_prefill_s,
        "one_card_decode_step_ms_mean_after_first":
            float(np.mean(one_step_ms[1:])),
        "launches": launches, "flash_by_design": flash_designs,
        "decode_by_design": decode_designs, "peak_memory_gb": peak_gb,
        "bitwise_one_card": True, "sample": tokens[0].tolist(),
    }
    emit("serve_mesh", **out)
    del params, logits, one_logits
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism inside an agent: two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# Two ranks along "model" on the one card. NCCL refuses two ranks of one
# communicator on one device, so their collectives go through gloo, staged
# through pinned host memory: a check of values at the TP-local shapes, not
# a measure of tensor parallelism's speed.
TP_MESH = (1, 2)
TP_TIMEOUT_S = 600
# train_tp: Qwen2-0.5B in the data layout (each leaf split over "model")
# at microbatch 2, 1 agent x 2 x 512 tokens, 1 warm-up + 2 timed steps;
# held to the one-card step: losses rtol 5e-3 (two bf16 forwards summed in
# another order), parameters within combine_tolerance's bf16 limit.
TP_TRAIN_STEPS = 2
TP_LOSS_RTOL = 5e-3
# serve_tp: Mixtral-8x7B at full width and 8 of its 32 layers, capacity
# 4.0 (no drops, so decoding equals the teacher-forced forward), 2 prompts
# of 8192 tokens and 8 decode steps teacher-forced on the one-card path's
# greedy tokens.
TP_SERVE_CFG = dataclasses.replace(mixtral_8x7b.CONFIG, num_layers=8,
                                   capacity_factor=4.0)
TP_SERVE = (2, 8192, 8192 + 8, 8)
# FSDP and EP over "data" beside TP over "model": four ranks at (data 2,
# model 2) on the one card over gloo, as TP_MESH's two. train_pod:
# Mixtral-8x7B at full width and 2 of its 32 layers in the pod layout (one
# agent: a "pod" axis of 1), microbatch 1 of 2 x 512 tokens (1 x 512 a
# data rank), the load-balance loss at weight 1 so that its per-rank
# control shows; 1 warm-up + 2 timed steps against the one-card launcher
# and a float32 run by train_tp's rules. serve_2d: serve_tp's Mixtral,
# prompts and fed tokens with the weights also split over "data" (at
# model 2 the reference's rule picks 2-D from 6 layers up), 1 row a rank.
POD_TRAIN_CFG = dataclasses.replace(mixtral_8x7b.CONFIG, num_layers=2)
POD_TRAIN_SHAPE = ShapeConfig("train_pod", 512, 2, "train")
POD_AUX = 1.0
# phase -> (mesh shape, axes) of its rank processes
RANK_MESHES = {
    "train_tp": (TP_MESH, ("data", "model")),
    "serve_tp": (TP_MESH, ("data", "model")),
    "train_pod": ((1, 2, 2), ("pod", "data", "model")),
    "serve_2d": ((2, 2), ("data", "model")),
}


def tp_train_config():
    return dataclasses.replace(get_train_config("qwen2-0.5b"),
                               agent_layout="data", microbatch=2)


def tp_batches(cfg, art) -> list:
    """The phase's batches: TRAIN_MESH_SHAPE's stream, 1 + TP_TRAIN_STEPS."""
    stream = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_MESH_SHAPE.seq_len,
        num_agents=1, dirichlet_alpha=0.3, seed=1))
    batch_fn = make_batch_fn(stream, art.batch_shapes, cfg.vocab_size)
    return [batch_fn(k) for k in range(1 + TP_TRAIN_STEPS)]


def own_wo_partial(rank: int):
    """The control: on ``rank`` 0, attention keeps its own partial sum
    after ``wo`` (it still joins the all-reduce, so the other rank does not
    wait), put in here by swapping attention's view of ``models.layers``."""
    real = attention.layers
    if rank != 0:
        return real

    def keep_own(params, x, compute_dtype, partial):
        y = real.row_split_apply(params, x, compute_dtype, False)
        if partial:
            sharding_hints.reduce_from_tp(y)
        return y

    faulty = {k: getattr(real, k) for k in dir(real) if not k.startswith("__")}
    faulty["row_split_apply"] = keep_own
    return types.SimpleNamespace(**faulty)


def tp_rank_train(mesh, rank: int, work: str, seed: int) -> dict:
    """One rank of train_tp: the launcher's ``data`` layout step on the
    ``DeviceMesh`` (its half of every split leaf), then the sparse gossip
    at W = [1] (``gossip.mix_sparse_p2p``: one combine launch a leaf, the
    leaf unchanged); then the control from the same start. Rank 0 saves
    the whole trees (``gather_tree``) of both runs."""
    cfg, tcfg = qwen2_0_5b.CONFIG, tp_train_config()
    art = train.build_train_artifacts(cfg, tcfg, TRAIN_MESH_SHAPE, mesh,
                                      np.eye(1))
    batches = tp_batches(cfg, art)
    schedule = gossip.build_schedule(np.eye(1))

    def run():
        state = art.init_state(seed)
        steps = []
        for batch in batches:
            local = sharding.shard_tree(batch, art.batch_specs, mesh)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = art.step_fn(state, local)
            state["params"] = gossip.mix_sparse_p2p(
                state["params"], schedule, mesh, ("data",))
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"loss": loss,
                          "step_ms": (time.perf_counter() - t) * 1e3})
        return state, steps

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    state, steps = run()
    launches = {name: ops.launch_count(name) for name in KERNELS}
    leaves = len(tree_leaves(state["params"]))
    want = {"mixing_sgd_combine": leaves * len(batches),
            "flash_attention": 0, "decode_attention": 0}
    if launches != want:
        raise AssertionError(f"train_tp rank {rank}: launches {launches}, "
                             f"not {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    whole = sharding.gather_tree(state["params"], art.param_specs, mesh)
    if rank == 0:
        torch.save(tree_map(lambda t: t.cpu(), whole),
                   os.path.join(work, "params.pt"))
    del state, whole
    real_layers, attention.layers = attention.layers, own_wo_partial(rank)
    control, control_steps = run()
    attention.layers = real_layers
    whole = sharding.gather_tree(control["params"], art.param_specs, mesh)
    if rank == 0:
        torch.save(tree_map(lambda t: t.cpu(), whole),
                   os.path.join(work, "control_params.pt"))
    return {"steps": steps, "control_steps": control_steps,
            "launches": launches, "leaves": leaves, "peak_memory_gb": peak_gb,
            "local_shapes": {path: list(p.shape) for path, p in tree_paths(
                control["params"]) if path.endswith(("wq/kernel",
                                                     "embed/table"))}}


def tp_rank_serve(mesh, rank: int, work: str, seed: int) -> dict:
    """One rank of serve_tp: its part of Mixtral's weights (the two ranks
    draw the whole tree from the one-card seed in turn and keep their
    part), a prefill of the phase's prompts and the decode steps fed the
    one-card path's tokens, then the control. Rank 0 saves the logits of
    both runs; each rank asserts its launches by design and the shapes the
    flash kernel saw."""
    cfg = TP_SERVE_CFG
    b, prompt, max_len, steps = TP_SERVE
    arts = [serve.build_serve_artifacts(
        cfg, ShapeConfig("serve_tp", max_len, b, kind), mesh=mesh)
        for kind in ("prefill", "decode")]
    params = None
    for turn in range(2):
        if turn == rank:
            whole = serve_params(cfg, seed)
            params = tree_map(lambda t: t.clone(), sharding.shard_tree(
                whole, arts[0].param_specs, mesh))
            del whole
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    given = torch.load(os.path.join(work, "inputs.pt"))
    toks, fed = given["prompt"].to("cuda"), given["fed"].to("cuda")
    inputs = sharding.shard_tree({"tokens": toks}, arts[0].input_specs, mesh)
    seen, real_flash = [], ops.flash_attention

    def spy(q, *args, **kwargs):
        seen.append(list(q.shape))
        return real_flash(q, *args, **kwargs)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = arts[0].prefill_fn(params, inputs)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out, step_ms = [logits[:, 0].float()], []
        for t in range(steps):
            t1 = time.perf_counter()
            logits, caches = arts[1].step_fn(params, caches,
                                             fed[:, t:t + 1])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            out.append(logits[:, 0].float())
        kv_heads = {key: c["k"].shape[3] for key, c in caches.items()}
        del caches
        return torch.stack(out, dim=1), prefill_s, step_ms, kv_heads

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    ops.flash_attention = spy
    logits, prefill_s, step_ms, kv_heads = run()
    ops.flash_attention = real_flash
    launches = {name: ops.launch_count(name) for name in KERNELS}
    flash_designs = flash_mod.launch_count_by_design()
    decode_designs = decode_mod.launch_count_by_design()
    layers = attention_layers(cfg)
    local_q = [b, cfg.num_heads // TP_MESH[1], prompt,
               cfg.resolved_head_dim]
    if seen != [local_q] * layers or flash_designs != launches_by_design(
            flash_mod.DESIGNS, "wgmma", layers) or \
            decode_designs != launches_by_design(
                decode_mod.DESIGNS, "mma", layers * steps) or \
            launches["mixing_sgd_combine"]:
        raise AssertionError(
            f"serve_tp rank {rank}: flash saw {seen}, designs "
            f"{flash_designs} / {decode_designs}, launches {launches}")
    if set(kv_heads.values()) != {cfg.num_kv_heads // TP_MESH[1]}:
        raise AssertionError(f"serve_tp rank {rank}: cache heads {kv_heads}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rank == 0:
        torch.save(logits.cpu(), os.path.join(work, "logits.pt"))
    real_layers, attention.layers = attention.layers, own_wo_partial(rank)
    control = run()[0]
    attention.layers = real_layers
    if rank == 0:
        torch.save(control.cpu(), os.path.join(work, "control_logits.pt"))
    return {"prefill_seconds": prefill_s, "decode_step_ms": step_ms,
            "launches": launches, "flash_by_design": flash_designs,
            "decode_by_design": decode_designs, "flash_q": seen[0],
            "cache_kv_heads": cfg.num_kv_heads // TP_MESH[1],
            "peak_memory_gb": peak_gb}


def tp_rank_main(phase: str, rank: int, work: str, seed: int) -> None:
    """A rank process of ``train_tp`` / ``serve_tp`` / ``train_pod`` /
    ``serve_2d`` (started by ``run_tp_ranks``): the phase's mesh
    (``RANK_MESHES``) over gloo on the one card, its report in
    ``work/rank{rank}.json``."""
    shape, axes = RANK_MESHES[phase]
    mesh = launch_mesh.init_mesh(
        shape, axes, backend="gloo",
        init_method=f"file://{os.path.join(work, 'rendezvous')}", rank=rank,
        world_size=math.prod(shape),
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    fn = {"train_tp": tp_rank_train, "serve_tp": tp_rank_serve,
          "train_pod": pod_rank_train, "serve_2d": pod_rank_serve}[phase]
    report = fn(mesh, rank, work, seed)
    report["backend"] = torch.distributed.get_backend()
    report["coords"] = launch_mesh.coordinate(mesh)
    emit(f"{phase}_rank", rank=rank, **{k: report[k] for k in (
        "launches", "peak_memory_gb", "backend")})
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def run_tp_ranks(phase: str, work: str, seed: int) -> list[dict]:
    """Start the rank processes of ``phase`` on the card and wait for all:
    if one fails or the time runs out, the others are killed and the phase
    raises with every log's end. Returns their reports."""
    world = math.prod(RANK_MESHES[phase][0])
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in
            range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", phase,
         str(r), work, "--seed", str(seed)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + TP_TIMEOUT_S
    while any(p.poll() is None for p in procs) and \
            time.monotonic() < deadline and \
            all(p.poll() in (None, 0) for p in procs):
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()
    if any(p.returncode for p in procs):
        tails = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (exit {procs[r].returncode})\n"
                             + f.read()[-3000:])
        raise AssertionError(f"{phase}: a rank failed\n" + "\n".join(tails))
    reports = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def one_card_train_references(cfg, tcfg, shape, seed: int) -> dict:
    """The one-card launcher's run of ``cfg`` on ``tp_batches`` from
    ``seed`` (bf16) and a float32 run of the same steps from the same start
    (parameters cast), both on a ``Mesh((1, 1))`` description, one after
    the other; their parameters on the host, their losses and step times,
    each leaf's initial scale. The card is freed after each."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    one_card = launch_mesh.make_test_mesh((1, 1))
    torch.cuda.reset_peak_memory_stats()
    art = train.build_train_artifacts(cfg, tcfg, shape, one_card)
    batches = tp_batches(cfg, art)
    state = art.init_state(seed)
    start = tree_map(lambda t: t.to(torch.float32).cpu(), state["params"])
    scales = [leaf_scale(t) for t in tree_leaves(start)]
    runs = {}
    for name, c in (("one", cfg), ("fp32", cfg32)):
        if name == "fp32":
            params = tree_map(lambda t: t.to("cuda"), start)
            state = {"params": params, "opt": sgd.init(params), "step": 0}
        art = train.build_train_artifacts(c, tcfg, shape, one_card)
        steps = []
        for batch in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = art.step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"loss": loss,
                          "step_ms": (time.perf_counter() - t) * 1e3})
            if name == "fp32":
                # the last step's cached blocks released: Mixtral's
                # float32 step peaks within a few GB of the card's size
                torch.cuda.empty_cache()
        runs[name] = (tree_map(lambda t: t.cpu(), state["params"]), steps)
        del state, art
        torch.cuda.empty_cache()
    del start
    (one, one_steps), (truth, fp32_steps) = runs["one"], runs["fp32"]
    base = [leaf_distance(b, t) for b, t in zip(tree_leaves(one),
                                                tree_leaves(truth))]
    return {"truth": truth, "base": base, "scales": scales,
            "one_steps": one_steps, "fp32_steps": fp32_steps,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def leaf_distance(a, b) -> float:
    """max|a - b| of two leaves on the host, taken on the card."""
    return float((a.to("cuda", torch.float32) - b.to("cuda")).abs().max())


def held_to_references(refs: dict, parts: list, steps: list,
                       slicers=None):
    """(agrees, worst loss error over its limit, each leaf's error over its
    limit, the worst leaves) of a run across ranks against
    ``one_card_train_references``: its losses within TP_LOSS_RTOL of the
    one-card run's, and each leaf no farther from the float32 run than
    twice the one-card run is plus ``BF16_ULP_ATOL`` x its initial scale.
    ``parts`` are parameter trees — the whole tree, or each rank's part
    with ``slicers[i]`` cutting the same part of a whole tree — and a
    leaf's error is the largest over them."""
    loss_worst = max(
        abs(s["loss"] - o["loss"]) / (TP_LOSS_RTOL * abs(o["loss"]))
        for s, o in zip(steps, refs["one_steps"]))
    errs: dict = {}
    finite = True
    for i, part in enumerate(parts):
        truth = refs["truth"] if slicers is None else slicers[i](
            refs["truth"])
        for (path, a), t in zip(tree_paths(part), tree_leaves(truth)):
            errs[path] = max(errs.get(path, 0.0), leaf_distance(a, t))
            finite = finite and bool(torch.isfinite(a).all())
    ok, over, leaves = loss_worst <= 1.0 and finite, {}, {}
    for (path, err), d, s in zip(errs.items(), refs["base"], refs["scales"]):
        over[path] = err / (2 * d + BF16_ULP_ATOL * s)
        ok = ok and over[path] <= 1.0
        leaves[path] = {"err_over_limit": over[path],
                        "ranks_vs_fp32_max": err, "one_card_vs_fp32_max": d}
    worst = sorted(leaves.items(), key=lambda kv: -kv[1]["err_over_limit"])
    return ok, loss_worst, over, worst[:4]


def phase_train_tp(seed: int) -> dict:
    """Qwen2-0.5B's ``data`` layout split over "model" at full width (14 ->
    7 query heads and 2 -> 1 KV heads a rank, vocabulary 151936 -> 75968,
    d_ff 4864 -> 2432), two ranks sharing the card over gloo, against the
    one-card launcher step (``Mesh((1, 1))``) on the same batches: 1
    warm-up + 2 timed steps, each followed on the ranks by the sparse
    gossip at W = [1] (the combine once a local leaf a step). Losses rtol
    TP_LOSS_RTOL. Parameters by ``phase_serve_check``'s bf16 rule, leaf by
    leaf: the ranks' may be at most twice as far from a float32 run of the
    same steps from the same start (max abs error) as the one-card bf16
    run is, plus ``BF16_ULP_ATOL`` x the leaf's initial scale. (The
    combine's one-ulp limit against the one-card run refuses two bf16
    paths that round in another order: the key biases, whose gradient is
    zero but for rounding, and two-ulp steps of the embedding.) The
    control in which rank 0 keeps its own partial sum after ``wo`` must be
    refused by the same comparison."""
    t0 = time.perf_counter()
    cfg, tcfg = qwen2_0_5b.CONFIG, tp_train_config()
    refs = one_card_train_references(cfg, tcfg, TRAIN_MESH_SHAPE, seed)
    one_steps, fp32_steps = refs["one_steps"], refs["fp32_steps"]
    work = tempfile.mkdtemp(prefix="chip_smoke_train_tp_")
    reports = run_tp_ranks("train_tp", work, seed)
    got = torch.load(os.path.join(work, "params.pt"))
    control = torch.load(os.path.join(work, "control_params.pt"))
    ok, loss_worst, over, worst = held_to_references(
        refs, [got], reports[0]["steps"])
    c_ok, c_loss, c_over, _ = held_to_references(
        refs, [control], reports[0]["control_steps"])
    timed = [np.mean([s["step_ms"] for s in r["steps"][1:]])
             for r in reports]
    out = {
        "config": cfg.name, "layout": tcfg.agent_layout,
        "mesh": list(TP_MESH), "backend": reports[0]["backend"],
        "transport": "two ranks sharing one card over host-staged gloo: a "
                     "check of values, not of TP speed",
        "steps_by_rank": [r["steps"] for r in reports],
        "one_card_steps": one_steps, "fp32_steps": fp32_steps,
        "step_ms_mean_timed_by_rank": timed,
        "launches_by_rank": [r["launches"] for r in reports],
        "leaves_a_rank": reports[0]["leaves"],
        "local_shapes_rank0": reports[0]["local_shapes"],
        "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in reports],
        "loss_err_over_limit": loss_worst,
        "params_err_over_limit": max(over.values()),
        "params_rule": "max|tp - fp32| <= 2 x max|one card - fp32| + 1e-4 "
                       "x the leaf's initial scale, each leaf",
        "params_worst_leaves": worst,
        "control_loss_err_over_limit": c_loss,
        "control_params_err_over_limit": max(c_over.values()),
        "seconds": time.perf_counter() - t0,
    }
    emit("train_tp", **out)
    if not ok:
        raise AssertionError("train_tp: the ranks' losses or parameters "
                             "are beyond their limits")
    if c_ok:
        raise AssertionError("train_tp: the check cannot tell the control "
                             "(rank 0 keeps its own wo partial) apart")
    return out


def mixtral_serve_references(seed: int) -> dict:
    """``serve_tp``'s one-card path in this process (Mixtral-8x7B at full
    width and TP_SERVE_CFG's 8 layers): a prefill of 2 prompts of 8192
    tokens and 8 greedy decode steps, and the float32 forward (torch ops,
    each bf16 weight cast where used) at those positions; the prompts, the
    fed tokens and both logits kept on the host and the card freed."""
    cfg = TP_SERVE_CFG
    b, prompt, max_len, steps = TP_SERVE
    params = serve_params(cfg, seed)
    toks = serve_prompts(cfg, b, seed, prompt)
    art = serve.build_serve_artifacts(
        cfg, ShapeConfig("serve_tp", max_len, b, "prefill"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, caches = art.prefill_fn(params, {"tokens": toks})
    torch.cuda.synchronize()
    one_prefill_s = time.perf_counter() - t1
    one, fed, one_step_ms = [logits[:, 0].float()], [], []
    for _ in range(steps):
        fed.append(logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None])
        t1 = time.perf_counter()
        logits, caches = art.step_fn(params, caches, fed[-1])
        torch.cuda.synchronize()
        one_step_ms.append((time.perf_counter() - t1) * 1e3)
        one.append(logits[:, 0].float())
    one = torch.stack(one, dim=1)
    fed = torch.cat(fed, dim=1)
    del caches, logits
    torch.cuda.empty_cache()
    # The float32 forward at positions prompt-1 .. prompt+steps-1: the
    # sequence is padded to the chunked attention's multiple of 1024 (later
    # tokens change nothing before them: causal, and capacity 4.0 drops
    # nothing).
    seq = torch.cat([toks, fed], dim=1)
    pad = -seq.shape[1] % attention.CHUNK_Q
    seq = torch.cat([seq, seq.new_zeros((b, pad))], dim=1)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        truth, _ = model.forward(cfg32, params, {"tokens": seq}, remat=False)
    truth = truth[:, prompt - 1:prompt + steps].float().cpu()
    out = {"one": one.cpu(), "truth": truth, "prompt": toks.cpu(),
           "fed": fed.cpu(), "one_prefill_s": one_prefill_s,
           "one_step_ms": one_step_ms}
    del params, seq, toks, fed, one
    torch.cuda.empty_cache()
    return out


def serve_median_err(x, truth) -> float:
    """The median over (request, position) of each position's largest
    error against ``truth``."""
    return float((x - truth).abs().amax(dim=-1).flatten().median())


def phase_serve_tp(seed: int, refs: dict) -> dict:
    """Mixtral-8x7B at full width and 8 of its 32 layers split over
    "model" (32 -> 16 query heads and 8 -> 4 KV heads a rank, D = 128,
    window 4096, experts along F 14336 -> 7168), two ranks sharing the card
    over gloo, against ``mixtral_serve_references``. The ranks feed the
    one-card path's tokens (teacher-forced, so a bf16 tie cannot
    cascade). Held by ``phase_serve_check``'s MoE rule: the median over
    (request, position) of each position's largest error against the
    float32 forward at most twice the one-card path's plus 1e-4; the
    control in which rank 0 keeps its own partial sum after ``wo`` must be
    refused by it."""
    t0 = time.perf_counter()
    cfg = TP_SERVE_CFG
    b, prompt, max_len, steps = TP_SERVE
    one, truth = refs["one"], refs["truth"]
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_tp_")
    torch.save({"prompt": refs["prompt"], "fed": refs["fed"]},
               os.path.join(work, "inputs.pt"))
    reports = run_tp_ranks("serve_tp", work, seed)
    got = torch.load(os.path.join(work, "logits.pt"))
    control = torch.load(os.path.join(work, "control_logits.pt"))

    def median_err(x):
        return serve_median_err(x, truth)

    limit = 2 * median_err(one) + FP32_ORDER_ATOL
    out = {
        "config": cfg.name, "layers": cfg.num_layers,
        "capacity_factor": cfg.capacity_factor, "mesh": list(TP_MESH),
        "backend": reports[0]["backend"],
        "transport": "two ranks sharing one card over host-staged gloo: a "
                     "check of values, not of TP speed",
        "batch": b, "prompt": prompt, "decode_steps": steps,
        "one_card_prefill_seconds": refs["one_prefill_s"],
        "one_card_decode_step_ms_mean_after_first":
            float(np.mean(refs["one_step_ms"][1:])),
        "prefill_seconds_by_rank": [r["prefill_seconds"] for r in reports],
        "decode_step_ms_mean_after_first_by_rank": [
            float(np.mean(r["decode_step_ms"][1:])) for r in reports],
        "launches_by_rank": [r["launches"] for r in reports],
        "flash_by_design_by_rank": [r["flash_by_design"] for r in reports],
        "decode_by_design_by_rank": [r["decode_by_design"] for r in reports],
        "flash_q": reports[0]["flash_q"],
        "cache_kv_heads_a_rank": reports[0]["cache_kv_heads"],
        "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in reports],
        "tp_vs_fp32_median": median_err(got),
        "one_card_vs_fp32_median": median_err(one),
        "control_vs_fp32_median": median_err(control),
        "tp_vs_one_card_max": float((got - one).abs().max()),
        "logit_scale": float(truth.abs().mean()),
        "rule": "tp_vs_fp32_median <= 2 x one_card_vs_fp32_median + 1e-4",
    }
    if not (bool(torch.isfinite(got).all()) and got.shape == one.shape
            and out["tp_vs_fp32_median"] <= limit):
        raise AssertionError(f"serve_tp: {out}")
    if out["control_vs_fp32_median"] <= limit:
        raise AssertionError(f"serve_tp: the check cannot tell the control "
                             f"(rank 0 keeps its own wo partial) apart: "
                             f"{out}")
    out["seconds"] = time.perf_counter() - t0
    emit("serve_tp", **out)
    return out


def pod_train_config():
    return dataclasses.replace(get_train_config("mixtral-8x7b"),
                               agent_layout="pod", microbatch=1,
                               moe_aux_weight=POD_AUX)


def in_turn(mesh, fn):
    """``fn()`` on each rank of ``mesh`` in turn (a whole draw of the
    weights at a time on the card), the card's cache freed after each."""
    out = None
    for turn in range(torch.distributed.get_world_size()):
        if turn == torch.distributed.get_rank():
            out = fn()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    return out


def keep_own_part(fctx, grad):
    """FSDP's backward that keeps the rank's own part of the gradient
    without the sum over the "data" ranks (the control of ``train_pod``)."""
    n = grad.shape[fctx.dim] // fctx.dp.size
    return (grad.narrow(fctx.dim, fctx.dp.index * n, n).contiguous(),
            None, None)


def wrong_owner_exchange(real):
    """``sharding_hints._exchange`` with rank 0's dispatch blocks sent to
    the owners in reverse order (the all-to-all is still joined, so the
    other ranks do not wait): the control of ``serve_2d``."""
    def exchange(x, split, cat, ctx):
        if torch.distributed.get_rank() == 0 and split == 1:
            x = torch.cat(list(x.chunk(ctx.size, dim=split))[::-1],
                          dim=split)
        return real(x, split, cat, ctx)
    return exchange


POD_TRAIN_CONTROLS = ("fsdp_own_part", "per_rank_me")


def pod_rank_train(mesh, rank: int, work: str, seed: int) -> dict:
    """One rank of train_pod: the launcher's ``pod`` layout step on the
    ``DeviceMesh`` (its FSDP x TP part of every leaf, the experts split
    along E over "data"; its data rank's row of every microbatch), then the
    sparse gossip over "pod" at W = [1] (one combine launch a local leaf);
    then each control from the same start. Each rank saves its own part of
    the parameters of every run."""
    cfg, tcfg = POD_TRAIN_CFG, pod_train_config()
    art = train.build_train_artifacts(cfg, tcfg, POD_TRAIN_SHAPE, mesh,
                                      np.eye(1))
    batches = tp_batches(cfg, art)
    schedule = gossip.build_schedule(np.eye(1))

    def run():
        state = in_turn(mesh, lambda: art.init_state(seed))
        steps, counts = [], []
        for batch in batches:
            local = sharding.shard_tree(batch, art.batch_specs, mesh)
            sharding_hints.reset_dp_count()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = art.step_fn(state, local)
            state["params"] = gossip.mix_sparse_p2p(
                state["params"], schedule, mesh, ("pod",))
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"loss": loss,
                          "step_ms": (time.perf_counter() - t) * 1e3})
            counts.append({n: sharding_hints.dp_count(n) for n in (
                "fsdp_gather", "ep_dispatch", "ep_combine")})
        params = tree_map(lambda t: t.cpu(), state["params"])
        del state
        torch.cuda.empty_cache()
        return params, steps, counts

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    params, steps, counts = run()
    launches = {name: ops.launch_count(name) for name in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = len(tree_leaves(params))
    want = {"mixing_sgd_combine": leaves * len(batches),
            "flash_attention": 0, "decode_attention": 0}
    moe_layers = cfg.num_groups * sum(k in MOE_KINDS
                                      for k in cfg.block_pattern)
    # one dispatch and one combine a MoE layer, forward and recompute
    if launches != want or any(
            c["ep_dispatch"] != 2 * moe_layers or c["ep_combine"] !=
            2 * moe_layers or c["fsdp_gather"] < 1 for c in counts):
        raise AssertionError(f"train_pod rank {rank}: launches {launches}, "
                             f"not {want}; collectives {counts}")
    torch.save(params, os.path.join(work, f"params_rank{rank}.pt"))
    local_shapes = {path: list(p.shape) for path, p in tree_paths(params)}
    del params
    real_backward = sharding_hints._GatherFromFSDP.backward
    real_mean = sharding_hints.batch_mean
    control_steps = {}
    for control in POD_TRAIN_CONTROLS:
        if control == "fsdp_own_part":
            sharding_hints._GatherFromFSDP.backward = staticmethod(
                keep_own_part)
        else:
            sharding_hints.batch_mean = lambda t: t
        params, control_steps[control], _ = run()
        sharding_hints._GatherFromFSDP.backward = real_backward
        sharding_hints.batch_mean = real_mean
        torch.save(params, os.path.join(work, f"{control}_rank{rank}.pt"))
        del params
    return {"steps": steps, "control_steps": control_steps,
            "launches": launches, "leaves": leaves, "peak_memory_gb": peak_gb,
            "collectives_by_step": counts, "local_shapes": local_shapes}


def pod_rank_serve(mesh, rank: int, work: str, seed: int) -> dict:
    """One rank of serve_2d: its part of Mixtral's weights under the 2-D
    rule (the ranks draw the whole tree from the one-card seed in turn and
    keep their part: 4 of the 8 experts at F 7168, attention and the
    embeddings over both axes), its row of the prompts, a prefill and the
    decode steps fed the one-card path's tokens, then the control. Each
    rank saves its row's logits and asserts its launches by design, the
    shapes the flash kernel saw and its collectives."""
    cfg = TP_SERVE_CFG
    b, prompt, max_len, steps = TP_SERVE
    arts = [serve.build_serve_artifacts(
        cfg, ShapeConfig("serve_2d", max_len, b, kind), mesh=mesh)
        for kind in ("prefill", "decode")]
    over_data = sum(sharding.split_over(spec, mesh, ("data",))
                    for _, spec in tree_paths(arts[0].param_specs))
    params = in_turn(mesh, lambda: tree_map(
        lambda t: t.clone(), sharding.shard_tree(
            serve_params(cfg, seed), arts[0].param_specs, mesh)))
    given = torch.load(os.path.join(work, "inputs.pt"))
    toks, fed = given["prompt"].to("cuda"), given["fed"].to("cuda")
    inputs = sharding.shard_tree({"tokens": toks}, arts[0].input_specs, mesh)
    fed = sharding.shard_tree(fed, arts[1].input_specs, mesh)
    seen, real_flash = [], ops.flash_attention

    def spy(q, *args, **kwargs):
        seen.append(list(q.shape))
        return real_flash(q, *args, **kwargs)

    def run():
        sharding_hints.reset_dp_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = arts[0].prefill_fn(params, inputs)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out, step_ms = [logits[:, 0].float()], []
        for t in range(steps):
            t1 = time.perf_counter()
            logits, caches = arts[1].step_fn(params, caches,
                                             fed[:, t:t + 1])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            out.append(logits[:, 0].float())
        kv_heads = {key: c["k"].shape[3] for key, c in caches.items()}
        del caches
        counts = {n: sharding_hints.dp_count(n) for n in (
            "fsdp_gather", "ep_dispatch", "ep_combine")}
        return torch.stack(out, dim=1), prefill_s, step_ms, kv_heads, counts

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    ops.flash_attention = spy
    logits, prefill_s, step_ms, kv_heads, counts = run()
    ops.flash_attention = real_flash
    launches = {name: ops.launch_count(name) for name in KERNELS}
    flash_designs = flash_mod.launch_count_by_design()
    decode_designs = decode_mod.launch_count_by_design()
    layers = attention_layers(cfg)
    rows = b // RANK_MESHES["serve_2d"][0][0]
    local_q = [rows, cfg.num_heads // TP_MESH[1], prompt,
               cfg.resolved_head_dim]
    calls = 1 + steps
    if seen != [local_q] * layers or flash_designs != launches_by_design(
            flash_mod.DESIGNS, "wgmma", layers) or \
            decode_designs != launches_by_design(
                decode_mod.DESIGNS, "mma", layers * steps) or \
            launches["mixing_sgd_combine"] or \
            counts["ep_dispatch"] != layers * calls or \
            counts["ep_combine"] != layers * calls or not over_data:
        raise AssertionError(
            f"serve_2d rank {rank}: flash saw {seen}, designs "
            f"{flash_designs} / {decode_designs}, launches {launches}, "
            f"collectives {counts}, {over_data} leaves over data")
    if set(kv_heads.values()) != {cfg.num_kv_heads // TP_MESH[1]}:
        raise AssertionError(f"serve_2d rank {rank}: cache heads {kv_heads}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.save(logits.cpu(), os.path.join(work, f"logits_rank{rank}.pt"))
    real_exchange = sharding_hints._exchange
    sharding_hints._exchange = wrong_owner_exchange(real_exchange)
    control = run()[0]
    sharding_hints._exchange = real_exchange
    torch.save(control.cpu(), os.path.join(work, f"control_rank{rank}.pt"))
    local_experts = params["blocks"]["b0_swa_moe"]["ffn"]["gate"].shape
    return {"prefill_seconds": prefill_s, "decode_step_ms": step_ms,
            "launches": launches, "flash_by_design": flash_designs,
            "decode_by_design": decode_designs, "flash_q": seen[0],
            "cache_kv_heads": cfg.num_kv_heads // TP_MESH[1],
            "collectives": counts, "leaves_over_data": int(over_data),
            "local_expert_leaf": list(local_experts),
            "peak_memory_gb": peak_gb}


def phase_train_pod(seed: int) -> dict:
    """Mixtral-8x7B at full width and 2 of its 32 layers in the ``pod``
    layout on a (pod 1, data 2, model 2) mesh, four ranks sharing the card
    over gloo: FSDP over "data" (attention, the router and the embeddings
    gathered at their use, their gradients reduce-scattered), the 8 experts
    4 a data rank (EP, all-to-all there and back) at F 14336 -> 7168 over
    "model", 32 -> 16 query heads and 8 -> 4 KV heads a model rank; one
    agent, microbatch 1 of 2 x 512 tokens, a row a data rank; the
    load-balance loss at weight 1. Against ``one_card_train_references``
    (run first, the card freed before the ranks start) on the same
    batches: 1 warm-up + 2 timed steps, each followed on the ranks by the
    sparse gossip at W = [1]. Held by ``train_tp``'s rules, each rank's
    part against the same part of the float32 run; each control (FSDP's
    backward keeping the rank's own part unsummed; the load-balance loss's
    top-1 share over the rank's own row) must be refused by the same
    comparison."""
    t0 = time.perf_counter()
    cfg, tcfg = POD_TRAIN_CFG, pod_train_config()
    refs = one_card_train_references(cfg, tcfg, POD_TRAIN_SHAPE, seed)
    ref_seconds = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="chip_smoke_train_pod_")
    reports = run_tp_ranks("train_pod", work, seed)
    shape, axes = RANK_MESHES["train_pod"]
    desc = launch_mesh.make_test_mesh(shape, axes)
    specs = sharding.param_specs_train(
        train._stacked_state_shapes(cfg, 1)["params"], desc, "pod")
    slicers = [functools.partial(sharding.shard_tree, specs=specs, mesh=desc,
                                 coords=r["coords"]) for r in reports]

    def parts(name):
        """Each rank's saved part of a run's parameters (the files are
        removed once read)."""
        out = []
        for r in range(len(reports)):
            path = os.path.join(work, f"{name}_rank{r}.pt")
            out.append(torch.load(path))
            os.remove(path)
        return out

    ok, loss_worst, over, worst = held_to_references(
        refs, parts("params"), reports[0]["steps"], slicers)
    controls = {}
    for control in POD_TRAIN_CONTROLS:
        c_ok, c_loss, c_over, _ = held_to_references(
            refs, parts(control), reports[0]["control_steps"][control],
            slicers)
        controls[control] = {"agrees": c_ok, "loss_err_over_limit": c_loss,
                             "params_err_over_limit": max(c_over.values())}
    timed = [np.mean([s["step_ms"] for s in r["steps"][1:]])
             for r in reports]
    out = {
        "config": cfg.name, "layers": cfg.num_layers,
        "layout": tcfg.agent_layout, "mesh": list(shape),
        "backend": reports[0]["backend"],
        "transport": "four ranks sharing one card over host-staged gloo: a "
                     "check of values, not of FSDP's or TP's speed",
        "moe_aux_weight": tcfg.moe_aux_weight,
        "steps_by_rank": [r["steps"] for r in reports],
        "one_card_steps": refs["one_steps"],
        "fp32_steps": refs["fp32_steps"],
        "one_card_and_fp32_peak_memory_gb": refs["peak_memory_gb"],
        "references_seconds": ref_seconds,
        "step_ms_mean_timed_by_rank": timed,
        "launches_by_rank": [r["launches"] for r in reports],
        "collectives_by_step_rank0": reports[0]["collectives_by_step"],
        "leaves_a_rank": reports[0]["leaves"],
        "local_shapes_rank0": {k: v for k, v in reports[0][
            "local_shapes"].items() if k.endswith(("wq/kernel", "ffn/gate",
                                                   "embed/table"))},
        "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in reports],
        "loss_err_over_limit": loss_worst,
        "params_err_over_limit": max(over.values()),
        "params_rule": "max over ranks of max|rank's part - fp32's| <= 2 x "
                       "max|one card - fp32| + 1e-4 x the leaf's initial "
                       "scale, each leaf",
        "params_worst_leaves": worst,
        "controls": controls,
        "seconds": time.perf_counter() - t0,
    }
    emit("train_pod", **out)
    out["local_shapes_rank0_all"] = reports[0]["local_shapes"]
    if not ok:
        raise AssertionError("train_pod: the ranks' losses or parameters "
                             "are beyond their limits")
    for control, held in controls.items():
        if held["agrees"]:
            raise AssertionError(f"train_pod: the check cannot tell the "
                                 f"control {control} apart")
    return out


def phase_serve_2d(seed: int, refs: dict) -> dict:
    """``serve_tp``'s Mixtral (full width, 8 layers, capacity 4.0), prompts
    and fed tokens under serving's 2-D tensor parallelism on a (data 2,
    model 2) mesh, four ranks sharing the card over gloo: each rank holds
    4 of the 8 experts at F 7168 (the dispatch buffer's blocks to their
    owners and back by all-to-all over "data"), attention and the
    embeddings split over both axes (gathered over "data" at their use),
    and 1 of the 2 rows. Held against ``mixtral_serve_references`` by
    ``serve_tp``'s median-position rule; the control in which rank 0 sends
    each expert owner another owner's block must be refused by it."""
    t0 = time.perf_counter()
    cfg = TP_SERVE_CFG
    b, prompt, max_len, steps = TP_SERVE
    one, truth = refs["one"], refs["truth"]
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_2d_")
    torch.save({"prompt": refs["prompt"], "fed": refs["fed"]},
               os.path.join(work, "inputs.pt"))
    reports = run_tp_ranks("serve_2d", work, seed)

    def rows(name):
        """The logits of every data rank's row at model coordinate 0."""
        by_row = {r["coords"]["data"]: torch.load(
            os.path.join(work, f"{name}_rank{i}.pt"))
            for i, r in enumerate(reports) if r["coords"]["model"] == 0}
        return torch.cat([by_row[d] for d in sorted(by_row)], dim=0)

    got, control = rows("logits"), rows("control")
    limit = 2 * serve_median_err(one, truth) + FP32_ORDER_ATOL
    out = {
        "config": cfg.name, "layers": cfg.num_layers,
        "capacity_factor": cfg.capacity_factor,
        "mesh": list(RANK_MESHES["serve_2d"][0]),
        "backend": reports[0]["backend"],
        "transport": "four ranks sharing one card over host-staged gloo: a "
                     "check of values, not of 2-D TP's speed",
        "batch": b, "prompt": prompt, "decode_steps": steps,
        "one_card_prefill_seconds": refs["one_prefill_s"],
        "one_card_decode_step_ms_mean_after_first":
            float(np.mean(refs["one_step_ms"][1:])),
        "prefill_seconds_by_rank": [r["prefill_seconds"] for r in reports],
        "decode_step_ms_mean_after_first_by_rank": [
            float(np.mean(r["decode_step_ms"][1:])) for r in reports],
        "launches_by_rank": [r["launches"] for r in reports],
        "flash_by_design_by_rank": [r["flash_by_design"] for r in reports],
        "decode_by_design_by_rank": [r["decode_by_design"] for r in reports],
        "collectives_by_rank": [r["collectives"] for r in reports],
        "leaves_over_data": reports[0]["leaves_over_data"],
        "local_expert_leaf": reports[0]["local_expert_leaf"],
        "flash_q": reports[0]["flash_q"],
        "cache_kv_heads_a_rank": reports[0]["cache_kv_heads"],
        "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in reports],
        "two_d_vs_fp32_median": serve_median_err(got, truth),
        "one_card_vs_fp32_median": serve_median_err(one, truth),
        "control_vs_fp32_median": serve_median_err(control, truth),
        "two_d_vs_one_card_max": float((got - one).abs().max()),
        "rule": "two_d_vs_fp32_median <= 2 x one_card_vs_fp32_median + 1e-4",
    }
    if not (bool(torch.isfinite(got).all()) and got.shape == one.shape
            and out["two_d_vs_fp32_median"] <= limit):
        raise AssertionError(f"serve_2d: {out}")
    if out["control_vs_fp32_median"] <= limit:
        raise AssertionError(f"serve_2d: the check cannot tell the control "
                             f"(rank 0's blocks to the wrong owners) apart: "
                             f"{out}")
    out["seconds"] = time.perf_counter() - t0
    emit("serve_2d", **out)
    return out


def pod_local_combine(seed: int, reports_shape) -> dict:
    """The per-agent combine (``gossip.mix_sparse_p2p``'s launch) at
    ``train_pod``'s largest local leaf, ``reports_shape``, with one
    received row at W's row (0.625, 0.375): ``hold_per_agent_combine``."""
    n = math.prod(reports_shape)
    out = hold_per_agent_combine(seed + 29, n, [0.625, 0.375],
                                 "per-agent combine at train_pod's largest "
                                 "local leaf")
    out["leaf_shape"] = list(reports_shape)
    emit("pod_local_combine", **out)
    return out


def tp_local_attention_kernels(seed: int) -> dict:
    """Both attention kernels alone at the TP-local shapes of the two
    phases (a rank's heads at model = 2), held to their plain versions at
    the data-scaled limit and timed beside their bounds, their plain
    versions and SDPA: Mixtral's prefill layer q [2, 16, 8192, 128], k/v
    [2, 4, 8192, 128], window 4096; its decode step q [2, 16, 1, 128]
    against the [2, 4, 4096, 128] ring; Qwen2-0.5B's layer q [32, 7, 8192,
    64], k/v [32, 1, 8192, 64], causal."""
    return local_attention_kernels(seed + 27, 2, True, "tp_local_attention")


def pod_local_attention_kernels(seed: int) -> dict:
    """The same at ``serve_2d``'s local shapes (a rank's heads at model = 2
    and its one row at data = 2): Mixtral's prefill layer q [1, 16, 8192,
    128], k/v [1, 4, 8192, 128], window 4096, and its decode step q [1,
    16, 1, 128] against the [1, 4, 4096, 128] ring."""
    return local_attention_kernels(seed + 28, 1, False,
                                   "pod_local_attention")


def local_attention_kernels(seed: int, rows: int, with_qwen: bool,
                            tag: str) -> dict:
    """Mixtral's flash layer and decode step at ``rows`` requests and a
    rank's heads at model = 2 (and Qwen2-0.5B's layer at model 2
    ``with_qwen``), each held to its plain version at the data-scaled limit
    with its faulty controls refused, and timed beside its bound, its plain
    version and SDPA; emitted as ``tag``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, flash, refused = torch.bfloat16, [], []
    mix, qwen = TP_SERVE_CFG, qwen2_0_5b.CONFIG
    t = TP_MESH[1]
    cases = (
        ("Mixtral-8x7B prefill layer at model 2 (window 4096)", rows,
         mix.num_heads // t, mix.num_kv_heads // t, mix.resolved_head_dim,
         mix.sliding_window),
    ) + ((("Qwen2-0.5B layer at model 2", 32, qwen.num_heads // t,
           qwen.num_kv_heads // t, qwen.resolved_head_dim, None),)
         if with_qwen else ())
    for name, b, h, kv, d, window in cases:
        q, k, v = attn_inputs(gen, b, h, kv, SERVE_PROMPT, SERVE_PROMPT, d,
                              bf16)
        res, refusals = hold_flash_layer(
            f"flash {name} q={list(q.shape)} k={list(k.shape)} bf16", q, k,
            v, requests=tuple(sorted({0, b - 1})), window=window)
        refused += refusals
        if res["design"] != "wgmma":
            raise AssertionError(f"{res['case']} ran {res['design']}")
        timed = time_flash_layer(q, k, v, window=window)

        def plain_by_request():
            for i in range(b):
                ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        window=window)

        plain_ms = time_cuda(plain_by_request, reps=1)
        if window is None:
            def library():
                return library_attention(q, k, v, True)
            call = "scaled_dot_product_attention(is_causal, enable_gqa), " \
                   "flash backend"
        else:
            mask = attention.causal_mask(SERVE_PROMPT, SERVE_PROMPT, window,
                                         "cuda")
            kk, vv = repeat_kv(k, h), repeat_kv(v, h)

            def library():
                return library_attention_masked(q, kk, vv, mask)
            call = "scaled_dot_product_attention(attn_mask=window mask), " \
                   f"efficient backend, k/v repeated to {h} heads"
        lib_held = hold(f"SDPA vs the flash kernel ({name})", library(),
                        ops.flash_attention(q, k, v, window=window),
                        scaled=True)
        lib_ms = time_cuda(library, reps=TIMING_REPS)
        flash.append({
            "case": name, "q": list(q.shape), "k": list(k.shape),
            "window": window, "design": res["design"],
            "max_abs_err": res["max_abs_err"],
            "largest_err_over_limit": res["largest_err_over_limit"],
            **timed, "plain_ms": plain_ms,
            "plain_note": f"plain version run request by request, {b} calls",
            "library_ms": lib_ms, "ms_over_library_ms": timed["ms"] / lib_ms,
            "library_call": call,
            "library_vs_kernel_max_abs_err": lib_held["max_abs_err"],
        })
        del q, k, v, library
        torch.cuda.empty_cache()
    q, k, v = attn_inputs(gen, rows, mix.num_heads // t,
                          mix.num_kv_heads // t, 1, mix.sliding_window,
                          mix.resolved_head_dim, bf16)
    _, refusals, decode = hold_decode_step(
        "Mixtral-8x7B step at model 2 (4096-slot ring)", q, k, v,
        mix.sliding_window, decode_mod.tile_slots(bf16, mix.resolved_head_dim))
    refused += refusals
    del q, k, v
    torch.cuda.empty_cache()
    emit(tag, flash=flash, decode=decode, refused=refused)
    return {"flash_attention": flash, "decode_attention": [decode]}


# ---------------------------------------------------------------------------
# The runtime: elastic training over the design service (runtime/)
# ---------------------------------------------------------------------------


def int8_quantization_error(x: torch.Tensor, q: torch.Tensor,
                            scale: torch.Tensor) -> float:
    """Largest ``|q·scale − x| / scale`` in float32, before the decode's
    cast back to the leaf's dtype (that cast adds up to half an ulp of the
    leaf's dtype at the value)."""
    s32 = scale.to(torch.float32)
    err = (q.to(torch.float32) * s32 - x.to(torch.float32)).abs_().max()
    return float(err / s32)


def hold_compressed(card: list, cpu: list, what: str) -> None:
    """One leaf's compressed payload on the card against the port's CPU
    result, bitwise: top-k ``(idx, vals)``, int8 ``(q, scale)`` and both
    decodes."""
    for kind, (c, h) in zip(("topk", "int8"), zip(card, cpu)):
        for i, (a, b) in enumerate(zip(c, h)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(
                    f"compression {what}: {kind} part {i} on the card is "
                    "not the CPU's")


def compression_check(one: dict, seed: int) -> dict:
    """int8 and top-k (1 %) of one agent's parameters on the card: the
    bytes against ``compressed_kappa``, the quantization error, and the
    embedding leaf and layer 0's leaves held bitwise against the port's
    CPU result."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    q8 = compression.int8_compress(one)
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t
    t = time.perf_counter()
    top = compression.topk_compress(one, ELASTIC_TOPK)
    torch.cuda.synchronize()
    topk_s = time.perf_counter() - t
    if q8.nbytes != compression.compressed_kappa(one, "int8"):
        raise AssertionError(f"int8 bytes {q8.nbytes}")
    if top.nbytes != compression.compressed_kappa(
            one, "topk", fraction=ELASTIC_TOPK):
        raise AssertionError(f"top-k bytes {top.nbytes}")
    worst = 0.0
    for leaf, (q, scale, dtype) in zip(tree_leaves(one), q8.payload):
        if scale.dtype != leaf.dtype or dtype != leaf.dtype:
            raise AssertionError("int8 scale not in the leaf's dtype")
        worst = max(worst, int8_quantization_error(leaf, q, scale))
    if not worst <= 0.5 + 1e-5:
        raise AssertionError(
            f"int8: |q*scale - x| reaches {worst} x scale, not <= 1/2")
    decoded = q8.decode()
    decode_err = max(
        float(((d.to(torch.float32) - x.to(torch.float32)).abs().max())
              / s.to(torch.float32))
        for d, x, (_, s, _) in zip(tree_leaves(decoded), tree_leaves(one),
                                   q8.payload))
    del decoded

    def parts(tree):
        """[(top-k idx, vals, decode), (q, scale, decode)] of one leaf."""
        tk = compression.topk_compress(tree, ELASTIC_TOPK)
        i8 = compression.int8_compress(tree)
        out = []
        for k in range(len(tk.payload)):
            out.append((
                [tk.payload[k][0], tk.payload[k][1],
                 tree_leaves(tk.decode())[k]],
                [i8.payload[k][0], i8.payload[k][1],
                 tree_leaves(i8.decode())[k]]))
        return out

    embed = one["embed"]["table"]
    pos = next(i for i, (p, _) in enumerate(tree_paths(one))
               if p == "embed/table")
    card_embed = [
        [top.payload[pos][0], top.payload[pos][1],
         tree_leaves(top.decode())[pos]],
        [q8.payload[pos][0], q8.payload[pos][1],
         tree_leaves(q8.decode())[pos]]]
    t = time.perf_counter()
    cpu_embed = parts({"t": embed.cpu()})[0]
    cpu_embed_s = time.perf_counter() - t
    hold_compressed(card_embed, list(cpu_embed), "embed/table")
    del card_embed, cpu_embed
    layer0 = {p: x[0] for p, x in tree_paths(one)
              if p.startswith("blocks/")}
    card_layer = parts(layer0)
    cpu_layer = parts({p: x.cpu() for p, x in layer0.items()})
    for path, c, h in zip(layer0, card_layer, cpu_layer):
        hold_compressed(list(c), list(h), f"layer 0 {path}")
    return {
        "int8_bytes": q8.nbytes, "topk_bytes": top.nbytes,
        "topk_fraction": ELASTIC_TOPK, "int8_seconds_on_card": int8_s,
        "topk_seconds_on_card": topk_s,
        "embed_cpu_seconds": cpu_embed_s,
        "int8_max_quantization_err_over_scale": worst,
        "int8_max_decode_err_over_scale": decode_err,
        "held_bitwise": ["embed/table"] + [f"layer 0 {p}" for p in layer0],
    }


def error_feedback_check(grads_one: dict) -> dict:
    """One ``ErrorFeedback`` step of top-k (1 %) over one agent's
    gradients: the residual is the gradient off the kept coordinates and
    zero on them, so residual + decode is the gradient bitwise."""
    ef = compression.ErrorFeedback()
    torch.cuda.synchronize()
    t = time.perf_counter()
    comp = ef.step(grads_one, lambda tr: compression.topk_compress(
        tr, ELASTIC_TOPK))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    for g, r, d in zip(tree_leaves(grads_one), tree_leaves(ef.residual),
                       tree_leaves(comp.decode())):
        if not torch.equal(r + d, g) or bool(((r != 0) & (d != 0)).any()):
            raise AssertionError("error feedback: residual + decode != g")
    return {"seconds_on_card": seconds, "nbytes": comp.nbytes,
            "residual_l1": float(sum(r.to(torch.float32).abs().sum()
                                     for r in tree_leaves(ef.residual)))}


def elastic_update_check(old, rows, wrong_rows, params, grads, plan,
                         w_new, w_prev, lr: float, seed: int) -> dict:
    """The first step's ``fused_update`` at a new membership against its
    plain version on every leaf, to one bf16 ulp, with the agents pushed
    apart first: noise of each leaf's scale is added to the stacked
    parameters ``old`` the membership came from, and the new stack is its
    rows ``rows`` (which must be what the service's re-map gave,
    ``params``); ``plan`` is the new design ``w_new``'s. Faulty controls,
    each refused on every leaf: the previous
    membership's W re-indexed by ``rows`` (a stale plan), the rows of a
    shrink or grow that keeps the wrong agent (``wrong_rows``), and each
    agent's neighbour rows taken from another agent."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    dev = torch.device("cuda")
    rows_t = torch.as_tensor(rows, device=dev)
    controls = [("wrong_neighbour_rows", None, plan.idx.roll(1, dims=0),
                 plan.weights)]
    if w_prev is not None:
        w_stale = w_prev[np.ix_(rows, rows)]
        if np.array_equal(w_stale, w_new):
            raise AssertionError("the stale-W control is the new W")
        stale = dpsgd.mixing_plan(w_stale, dev)
        controls.append(("previous_w", None, stale.idx, stale.weights))
    if wrong_rows is not None:
        controls.append(("wrong_agent_rows",
                         torch.as_tensor(wrong_rows, device=dev),
                         plan.idx, plan.weights))
    refused = {name: math.inf for name, *_ in controls}
    worst = max_err = 0.0
    for (path, p_old), p_new, g in zip(tree_paths(old), tree_leaves(params),
                                       tree_leaves(grads)):
        if not torch.equal(p_old[rows_t], p_new):
            raise AssertionError(f"re-map of {path} is not rows {rows}")
        scale = leaf_scale(p_new)
        x_old = torch.empty_like(p_old).normal_(generator=gen).mul_(scale)
        x_old.add_(p_old)
        x = x_old[rows_t]
        a = x.shape[0]
        g2 = g.reshape(a, -1)
        fused = dpsgd.fused_update({"l": x}, {"l": g}, plan, lr)["l"]
        fused = fused.reshape(a, -1)
        want = ref.mixing_sgd_combine_stacked_ref(
            x.reshape(a, -1), plan.idx, plan.weights, g2, lr=lr)
        rtol, atol = combine_tolerance(x.dtype, scale)
        err = assert_close(fused, want, rtol, f"elastic first step {path}",
                           atol=atol)
        max_err = max(max_err, err)
        worst = max(worst, err / scale)
        del want
        for name, bad_rows, idx, weights in controls:
            xc = x if bad_rows is None else x_old[bad_rows]
            faulty = ref.mixing_sgd_combine_stacked_ref(
                xc.reshape(a, -1), idx, weights, g2, lr=lr)
            agree, _, over = compare(fused, faulty, rtol, atol)
            if agree:
                raise AssertionError(
                    f"elastic {path}: the check cannot tell the kernel's "
                    f"output from an update with the fault {name}")
            refused[name] = min(refused[name], over)
            del faulty, xc
        del x_old, x, fused
        torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "max_err_over_scale": worst,
            "fewest_refused_err_over_limit": refused,
            "rtol": BF16_ULP_RTOL, "atol_over_scale": BF16_ULP_ATOL}


def check_elastic_record(k: int, rec, svc, priced: list) -> None:
    """Event ``k``'s record and pricing calls against the JAX package's
    service (``JAX_ELASTIC_RECORDS``): the trail exactly, τ and every
    pricing call's makespan at ``ELASTIC_RTOL``."""
    kind, decision, tier, m, retries, faults, tau, spans = \
        JAX_ELASTIC_RECORDS[k]
    got = (rec.event, rec.decision, rec.tier, svc.num_agents, rec.retries,
           len(rec.faults))
    if got != (kind, decision, tier, m, retries, faults):
        raise AssertionError(
            f"elastic event {k}: {got}, the reference gives "
            f"{(kind, decision, tier, m, retries, faults)}")
    if not math.isclose(rec.tau, tau, rel_tol=ELASTIC_RTOL, abs_tol=0.0):
        raise AssertionError(f"elastic event {k}: tau {rec.tau!r}, not {tau}")
    makespans = [c["makespan"] for c in priced]
    if len(makespans) != len(spans) or not all(
            math.isclose(a, b, rel_tol=ELASTIC_RTOL, abs_tol=0.0)
            for a, b in zip(makespans, spans)):
        raise AssertionError(
            f"elastic event {k}: pricing calls {makespans}, not {spans}")


def phase_elastic(seed: int) -> dict:
    """``examples/elastic_failover.py`` at full width on the card:
    Qwen2-0.5B (24 layers, d 896, bf16) trained by D-PSGD by 8 agents while
    ``runtime.design_service`` re-designs W through the example's stream —
    a link sag, ``AgentLeave(1)`` during a pricing outage (every attempt
    raises: the incumbent is renormalized), ``AgentLeave(5)``, a join, the
    recovery — with the torch pricing engine on the card, and
    ``shrink_state``/``grow_state`` re-mapping the stacked parameters on
    the card after each membership change. kappa is one agent's int8 bytes
    (``compressed_kappa``). The records, τ and pricing calls are held to
    the JAX package's service (``JAX_ELASTIC_*``); at each membership the
    first step's kernel is held to its plain version on every leaf with
    the faulty controls refused, then 1 warm-up + 2 timed steps run
    through ``make_dpsgd_step``, exactly 14 launches each."""
    cfg = qwen2_0_5b.CONFIG
    dev = torch.device("cuda")
    lr = ELASTIC_LR
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = dpsgd.replicate_for_agents(
        model.init(cfg, seed, device=dev), ELASTIC_AGENTS)
    leaves = len(tree_leaves(params))
    one = tree_map(lambda p: p[0], params)
    kappa = compression.compressed_kappa(one, "int8")
    if kappa != JAX_ELASTIC_KAPPA:
        raise AssertionError(f"kappa {kappa}, not {JAX_ELASTIC_KAPPA}")
    compressed = compression_check(one, seed)
    del one
    torch.cuda.empty_cache()

    priced: list = []
    real_simulate = design_service.simulate

    def timed_simulate(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_simulate(*args, **kwargs)
        torch.cuda.synchronize()
        priced.append({"engine": kwargs.get("engine", "batched"),
                       "makespan": float(res.makespan),
                       "seconds": time.perf_counter() - t})
        return res

    design_service.simulate = timed_simulate
    und = roofnet_like(seed=0)
    ov = build_overlay(und, lowest_degree_nodes(und, ELASTIC_AGENTS))
    t = time.perf_counter()
    svc = design_service.DesignService(
        ov, kappa, design_service.ServiceConfig(
            design_iterations=12, engine="torch"), device=None)
    start_seconds = time.perf_counter() - t
    if (svc.num_agents, svc.tau) != JAX_ELASTIC_START:
        raise AssertionError(
            f"elastic start {(svc.num_agents, svc.tau)}, not "
            f"{JAX_ELASTIC_START}")
    worst_edges = sorted(svc._binc.edges)[:3]
    free = next(n for n in sorted(und.graph.nodes) if n not in set(ov.agents))
    events = [
        LinkStateChange(time=1.0, scales={e: 0.3 for e in worst_edges}),
        AgentLeave(time=2.0, agent=1),
        AgentLeave(time=3.0, agent=5),
        AgentJoin(time=4.0, node=free),
        LinkStateChange(time=5.0, scales={e: 1.0 for e in worst_edges}),
    ]
    stream = SyntheticTokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=ELASTIC_SEQ,
        num_agents=ELASTIC_AGENTS, dirichlet_alpha=0.3, seed=1))

    def loss_fn(p, b):
        return model.loss(cfg, p, {"tokens": b}, remat=False)[0]

    step_fn = dpsgd.make_dpsgd_step(loss_fn, learning_rate=lr)
    segments, records = [], []
    old, rows, wrong_rows, w_prev = params, list(range(ELASTIC_AGENTS)), \
        None, None
    ef = None
    launches = 0
    k = 0
    for seg in range(len(events) + 1):
        m = svc.num_agents
        plan = dpsgd.mixing_plan(svc.design, dev)
        batch0 = torch.from_numpy(
            stream.stacked_batch(k, 1, ELASTIC_SEQ)[:m]).to(dev)
        _, grads = dpsgd.agent_grads(loss_fn, params, batch0)
        del batch0
        if seg == 0:
            ef = error_feedback_check(tree_map(lambda g: g[0], grads))
        held = elastic_update_check(old, rows, wrong_rows, params, grads,
                                    plan, svc.design, w_prev, lr, seed + seg)
        del grads, old
        torch.cuda.empty_cache()
        ops.reset_launch_count()
        step_ms, losses = [], []
        for _ in range(1 + ELASTIC_STEPS):
            batch = stream.stacked_batch(k, 1, ELASTIC_SEQ)[:m]
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, loss = step_fn(params, batch, plan, k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            k += 1
        seg_launches = ops.launch_count("mixing_sgd_combine")
        if seg_launches != (1 + ELASTIC_STEPS) * leaves:
            raise AssertionError(
                f"elastic m={m}: {seg_launches} mixing_sgd_combine "
                f"launches, not {1 + ELASTIC_STEPS} steps x {leaves} leaves")
        launches += seg_launches
        if not all(np.isfinite(losses)):
            raise AssertionError(f"elastic m={m}: non-finite loss {losses}")
        for path, p in tree_paths(params):
            if p.shape[0] != m:
                raise AssertionError(f"elastic: {path} has {p.shape[0]} rows")
        segment = {
            "agents": m, "neighbours": int(plan.idx.shape[1]),
            "rho": mixing.rho(svc.design), "tau": svc.tau,
            "losses": losses, "step_ms": step_ms,
            "step_ms_mean_timed": float(np.mean(step_ms[1:])),
            "launches": seg_launches, "first_step_check": held,
        }
        if m == 7:
            x = params["embed"]["table"]
            x = x.reshape(m, -1)
            g = torch.empty_like(x).normal_(
                generator=torch.Generator(device=dev).manual_seed(seed + 9))
            segment["embedding_leaf_combine"] = combine_times(x, g, plan, lr)
            del x, g
        segments.append(segment)
        if seg == len(events):
            break
        ev = events[seg]
        if ev.time == ELASTIC_OUTAGE_AT:
            svc.injector = FaultInjector(
                FaultPlan(seed=0, rate=1.0, modes=("raise",)),
                clock=svc.clock)
        before, w_prev = svc.members, svc.design
        priced.clear()
        t = time.perf_counter()
        rec = svc.process(ev)
        process_seconds = time.perf_counter() - t
        svc.injector = None
        check_elastic_record(seg, rec, svc, priced)
        old = params
        n = len(before)
        if isinstance(ev, AgentLeave):
            rows = [p for p, h in enumerate(before) if h in set(svc.members)]
            gone = next(p for p, h in enumerate(before)
                        if h not in set(svc.members))
            # the departed agent's row kept in place of the last survivor's
            wrong_rows = sorted(rows[:-1] + [gone])
            params = shrink_state(params, tuple(rows), n)
        elif isinstance(ev, AgentJoin):
            rows = list(range(n)) + [0] * (svc.num_agents - n)
            wrong_rows = list(range(n)) + [1] * (svc.num_agents - n)
            params = grow_state(params, svc.num_agents)
        else:
            rows, wrong_rows = list(range(n)), None
        records.append({
            "event": rec.event, "decision": rec.decision, "tier": rec.tier,
            "agents": svc.num_agents, "retries": rec.retries,
            "faults": len(rec.faults), "tau": rec.tau,
            "process_seconds": process_seconds,
            "pricing_calls": list(priced), "detail": rec.detail,
        })
    design_service.simulate = real_simulate
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if [s["agents"] for s in segments] != [8, 8, 7, 6, 7, 7]:
        raise AssertionError(
            f"elastic memberships {[s['agents'] for s in segments]}")
    out = {
        "config": cfg.name, "parameters_per_agent": model.parameter_count(cfg),
        "param_dtype": cfg.param_dtype, "leaves": leaves,
        "kappa_int8_bytes": kappa, "seq_len": ELASTIC_SEQ,
        "per_agent_batch": 1, "lr": lr, "warmup_steps": 1,
        "timed_steps": ELASTIC_STEPS, "engine": "torch",
        "service_start_seconds": start_seconds,
        "compression": compressed, "error_feedback": ef,
        "segments": segments, "events": records,
        "kernel_launches": launches,
        "max_abs_err": max(s["first_step_check"]["max_abs_err"]
                           for s in segments),
        "peak_memory_gb": peak_gb,
        "seconds": time.perf_counter() - t_phase,
    }
    del params, svc
    torch.cuda.empty_cache()
    emit("elastic", **out)
    return out


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
                causal=True, row_block=None):
    """Kernel on the whole batch. Plain version on the whole batch at the
    tables' tolerance, or (``requests``, the main path's shapes) request by
    request on those listed, at the data-scaled limit; with ``row_block``
    (causal) each request's plain version is made ``row_block`` query rows
    at a time, whose float32 logits fit where a whole request's would not.
    Returns (result, kernel output); the result names the design that
    ran."""
    before = flash_mod.launch_count_by_design()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    after = flash_mod.launch_count_by_design()
    ran = [name for name in after if after[name] != before[name]]
    picked = [slice(None)] if requests is None else [
        slice(i, i + 1) for i in requests]
    held = []
    for r in picked:
        if row_block is None:
            want = ref.flash_attention_ref(q[r], k[r], v[r], causal=causal,
                                           window=window, softcap=softcap)
            held.append(hold(what, got[r], want, scaled=requests is not None))
            del want
            continue
        for r0 in range(0, q.shape[2], row_block):
            rows = slice(r0, r0 + row_block)
            want = faulty_flash_plain(q[r, :, rows], k[r], v[r], None, r0,
                                      window, softcap)
            held.append(hold(what, got[r, :, rows], want, scaled=True))
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


def faulty_flash_plain(q, k, v, fault, row0: int = 0, window=None,
                       softcap=None):
    """The plain flash version (causal, the layer's window and softcap)
    with one fault, for the query rows ``row0 .. row0 + Sq - 1`` that
    ``q`` holds (``fault=None``: the plain version itself on those rows):
    ``"head_mod"`` puts query head h on KV head h % KV;
    ``"strict_causal"`` excludes the causal diagonal (key j valid for
    query i only when j < i); ``("drop", start, width)`` leaves keys
    ``start`` .. ``start + width - 1`` out (a kernel that skips one tile)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if fault == "head_mod":
        heads = torch.tensor([i % kv for i in range(h)], device=q.device)
        k, v, kv = k.index_select(1, heads), v.index_select(1, heads), h
    s = torch.einsum("bkgqd,bksd->bkgqs", ref._grouped(q, kv),
                     k.to(torch.float32)) * d**-0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(row0, row0 + sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = kpos < qpos if fault == "strict_causal" else kpos <= qpos
    if window is not None:
        valid = valid & (kpos > qpos - window)
    if isinstance(fault, tuple):
        _, start, width = fault
        valid = valid & ((kpos < start) | (kpos >= start + width))
    return ref._softmax_pv(s, valid, v).reshape(b, h, sq, d).to(q.dtype)


def layout_inputs(gen, b, h, kv, sq, sk, d, dtype, layout):
    """q, k, v in a case table's layout: "model" or "dense" (``attn_inputs``)
    or "fused" (sliced from one ``[B,S,H+2KV,D]`` tensor; ``sq == sk``)."""
    if layout != "fused":
        return attn_inputs(gen, b, h, kv, sq, sk, d, dtype,
                           model_layout=layout == "model")
    t = torch.randn((b, sq, h + 2 * kv, d), generator=gen,
                    device="cuda").to(dtype)
    return (t[:, :, :h].transpose(1, 2), t[:, :, h:h + kv].transpose(1, 2),
            t[:, :, h + kv:].transpose(1, 2))


def check_design_cases(gen, cases, head_dims, dtype, want: str) -> list[dict]:
    """A flash design's case table (the columns of FLASH_WGMMA_CASES) at
    every head_dim in ``head_dims``: each case held to the plain version at
    the tables' tolerance, asserted to run the design ``want``; rows that
    no key reaches (from ``sk - 1 + window`` on) are zeros exactly. bf16
    cases are also held at the main paths' data-scaled limit."""
    name = {torch.bfloat16: "bf16", torch.float32: "float32"}[dtype]
    results = []
    for d in head_dims:
        for b, h, kv, sq, sk, causal, window, cap, layout in cases:
            q, k, v = layout_inputs(gen, b, h, kv, sq, sk, d, dtype, layout)
            res, got = check_flash(
                f"flash b={b} h={h} kv={kv} sq={sq} sk={sk} d={d} "
                f"causal={causal} window={window} softcap={cap} {name} "
                f"({layout} layout)", q, k, v, window, cap, causal=causal)
            if res["design"] != want:
                raise AssertionError(f"{res['case']} ran {res['design']}")
            results.append(res)
            if dtype == torch.bfloat16:
                results.append(hold(
                    f"{res['case']} (data-scaled limit)", got,
                    ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, softcap=cap),
                    scaled=True))
            if window is not None and sq > sk - 1 + window:
                if bool(got[:, :, sk - 1 + window:].ne(0).any()):
                    raise AssertionError(f"{res['case']}: keyless rows not 0")
            del q, k, v, got
    return results


def check_decode_cases(gen, cases, dtype, want: str) -> list[dict]:
    """A decode design's case table (the columns of DECODE_MMA_CASES):
    each case held to the plain version, bf16 at the data-scaled limit and
    float32 at the tables' 2e-5, asserted to run the design ``want``; rows
    of length 0 are zeros exactly."""
    name = {torch.bfloat16: "bf16", torch.float32: "float32"}[dtype]
    results = []
    for b, h, kv, s, d, length, cap, layout in cases:
        q, k, v = attn_inputs(gen, b, h, kv, 1, s, d, dtype,
                              model_layout=layout == "model")
        n = (torch.tensor(length, dtype=torch.int32, device="cuda")
             if isinstance(length, list) else length)
        res, got = check_decode(
            f"decode b={b} h={h} kv={kv} s={s} d={d} length={length} "
            f"softcap={cap} {name} ({layout} layout)", q, k, v, n, cap,
            scaled=dtype == torch.bfloat16)
        if res["design"] != want:
            raise AssertionError(f"{res['case']} ran {res['design']}")
        results.append(res)
        lengths = length if isinstance(length, list) else [length] * b
        for i, li in enumerate(lengths):
            if li == 0 and bool(got[i].ne(0).any()):
                raise AssertionError(f"{res['case']}: length 0 is not zeros")
        del q, k, v, got
    return results


def phase_attention_check(seed: int) -> list[dict]:
    """Both attention kernels against their plain versions on the card at
    small shapes: the case tables of tests/test_kernels.py, ragged S,
    ``length`` as a [B] vector, and head_dim 16 of the smoke configs; the
    wgmma design of flash_attention at every head_dim
    (``FLASH_WGMMA_CASES``: window with softcap, non-causal Sq != Sk, S in
    {1, 77, 129, 1000}, groups of 1 and 7, strided and fused views, rows
    with no key) and its ffma design at every head_dim (``FLASH_FFMA_CASES``,
    the same table in float32 plus causal Sq > Sk), asserting each design
    ran; decode in float32 at head_dim
    256; the mma design of decode_attention (``DECODE_MMA_CASES``: groups
    1, 7 and 16, every head_dim, length 1 and S, S = 77, softcap 50, [B]
    lengths with a 0 (zeros exactly), strided views, Gemma2-2B's decode
    layer) at the data-scaled limit, and its ffma design
    (``DECODE_FFMA_CASES``: the same in float32 at every head_dim, and
    length 0) at 2e-5, asserting each design ran. Every
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

    results += check_design_cases(gen, FLASH_WGMMA_CASES,
                                  WGMMA_CASE_HEAD_DIMS, bf16, "wgmma")
    results += check_design_cases(gen, FLASH_FFMA_CASES, flash_mod.HEAD_DIMS,
                                  f32, "ffma")

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

    results += check_decode_cases(gen, DECODE_MMA_CASES, bf16, "mma")
    results += check_decode_cases(gen, DECODE_FFMA_CASES, f32, "ffma")
    torch.cuda.synchronize()
    emit("attention_check", cases=results, refused=refused)
    return results


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def serve_prompts(cfg, b: int, seed: int,
                  prompt: int = SERVE_PROMPT) -> torch.Tensor:
    """``b`` prompts of ``prompt`` tokens of ``cfg``'s vocabulary drawn from
    ``seed``, on the card."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, prompt), dtype=np.int32)
    ).to("cuda")


def frontend_inputs(cfg, b: int, seed: int) -> dict:
    """What a prompt carries besides its tokens: for the VLM, ``b`` x
    ``num_patches`` patch embeddings N(0, 1) in bf16 (the vision tower's
    output, which the repo stubs) drawn from ``seed`` on the card;
    nothing for the others."""
    if cfg.frontend != "vision_patches":
        return {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    return {"patch_embeds": torch.randn(
        (b, cfg.num_patches, cfg.d_model), generator=gen,
        device="cuda").to(torch.bfloat16)}


def attention_layers(cfg) -> int:
    """Layers of ``cfg`` with an attention mixer: one flash launch each a
    prefill, one decode launch each a step."""
    return cfg.num_groups * sum(kind in ATTN_KINDS
                                for kind in cfg.block_pattern)


def launches_by_design(designs, design: str, n: int) -> dict:
    """The launch counts by design when ``n`` launches all went to
    ``design``."""
    return {**dict.fromkeys(designs, 0), **({design: n} if n else {})}


def serve_params(cfg, seed: int):
    """Random parameters of ``cfg`` on the card from an explicit generator
    (the repo holds no checkpoint)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    return model.init(cfg, gen, device="cuda")


def phase_serve_check(seed: int, cfg, b: int, s: int,
                      forms=("float32", "bfloat16"), params=None) -> dict:
    """The serving path end to end on the card: prefill of ``b`` prompts of
    ``s`` tokens (after the VLM's patch positions) and CHECK_STEPS
    teacher-forced decode steps of ``cfg``, against ``model.forward``
    (torch ops, no kernel) at the same positions, in each of ``forms``:

    * float32 (the config with float32 parameters and compute, so the
      kernels' float32 paths): within the JAX package's own model
      tolerances, 2e-2 prefill / 3e-2 decode (tests/test_models_smoke.py).
    * bfloat16 (the served config): two bf16 paths through every layer
      round the residual stream differently and part by several bf16
      ulps at the logits, more than 2e-2 (0.0625 in the first run of
      Qwen2-0.5B), so each is held against the float32 forward of the
      same parameters: the kernel path may be at most twice as far from it
      as the torch-op path is, plus 1e-4 (float32 summation order). With
      MoE layers the rule holds the median over (request, position) of
      each position's largest error: a top-k choice near a tie flips under
      either path's bf16 rounding, and the flipped positions, a few of
      the nine, set the largest error of either path by chance.

    The float32 prefill must run the ``ffma`` flash design once an
    attention layer, and each float32 step the ``ffma`` decode design once
    an attention layer. Without the float32 form, the float32 forward runs
    on ``params`` as they are (each weight cast to float32 where it is
    used: the same values). ``params``: ``cfg``'s parameters
    (``serve_params`` when None; a float32 ``cfg`` draws them in float32
    and converts nothing). Returns the attention kernels' launches by
    design in each run."""
    cfg32 = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"
    )
    steps = CHECK_STEPS
    params = serve_params(cfg, seed) if params is None else params
    rng = np.random.default_rng(seed + 6)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s + steps), dtype=np.int32)
    ).to("cuda")
    extra = frontend_inputs(cfg, b, seed + 6)
    off = cfg.num_patches if extra else 0
    n_attn = attention_layers(cfg)
    launches = {}

    def forward(c, p):
        with torch.inference_mode():
            want, _ = model.forward(c, p, {"tokens": toks, **extra},
                                    remat=False)
        return want[:, off + s - 1:off + s + steps].to(torch.float32,
                                                       copy=True)

    def run(c, p):
        """(serving path's logits, forward's) at positions s-1 .. s+steps-1."""
        art = serve.build_serve_artifacts(
            c, ShapeConfig("serve_check", off + s + steps, b, "prefill")
        )
        want = forward(c, p)
        ops.reset_launch_count()
        logits, caches = art.prefill_fn(p, {"tokens": toks[:, :s], **extra})
        got = [logits[:, 0]]
        for t in range(steps):
            logits, caches = art.step_fn(p, caches, toks[:, s + t:s + t + 1])
            got.append(logits[:, 0])
        launches[c.compute_dtype] = {
            "flash_attention": flash_mod.launch_count_by_design(),
            "decode_attention": decode_mod.launch_count_by_design(),
        }
        pos = {key: c_["pos"].tolist() for key, c_ in caches.items()
               if "pos" in c_}
        if any(v != [off + s + steps] * c.num_groups for v in pos.values()):
            raise AssertionError(f"serve_check: cache positions {pos}")
        return torch.stack(got, dim=1), want

    err32 = bf16 = None
    if "float32" in forms:
        got32, truth = run(cfg32, tree_map(lambda p: p.to(torch.float32),
                                           params))
        flash32 = launches["float32"]["flash_attention"]
        if flash32 != launches_by_design(flash_mod.DESIGNS, "ffma", n_attn):
            raise AssertionError(f"serve_check {cfg.name} float32 prefill: "
                                 f"flash launches {flash32}")
        decode32 = launches["float32"]["decode_attention"]
        if decode32 != launches_by_design(decode_mod.DESIGNS, "ffma",
                                          n_attn * steps):
            raise AssertionError(f"serve_check {cfg.name} float32 decode: "
                                 f"decode launches {decode32}")
        err32 = {
            "prefill": assert_close(
                got32[:, 0], truth[:, 0], 2e-2,
                f"serve_check {cfg.name} float32 prefill logits"),
            "decode": assert_close(
                got32[:, 1:], truth[:, 1:], 3e-2,
                f"serve_check {cfg.name} float32 decode logits"),
        }
        del got32
    else:
        truth = forward(cfg32, params)
    if "bfloat16" in forms:
        got16, want16 = run(cfg, params)
        got16 = got16.float()
        kernel_err = (got16 - truth).abs()
        forward_err = (want16 - truth).abs()
        bf16 = {
            "kernel_path_vs_fp32_max": float(kernel_err.max()),
            "kernel_path_vs_fp32_mean": float(kernel_err.mean()),
            "forward_vs_fp32_max": float(forward_err.max()),
            "forward_vs_fp32_mean": float(forward_err.mean()),
            "kernel_path_vs_forward_max": float((got16 - want16).abs().max()),
        }
        held = ("kernel_path_vs_fp32_max", "forward_vs_fp32_max")
        if any(kind in MOE_KINDS for kind in cfg.block_pattern):
            per_pos = {
                "kernel_path_vs_fp32_by_position":
                    kernel_err.amax(dim=-1).flatten(),
                "forward_vs_fp32_by_position":
                    forward_err.amax(dim=-1).flatten(),
            }
            bf16.update({key: t.tolist() for key, t in per_pos.items()})
            bf16.update({key.replace("by_position", "median"):
                         float(t.median()) for key, t in per_pos.items()})
            held = ("kernel_path_vs_fp32_median", "forward_vs_fp32_median")
        if not bool(torch.isfinite(got16).all()) or not (
            bf16[held[0]] <= 2 * bf16[held[1]] + FP32_ORDER_ATOL
        ):
            raise AssertionError(f"serve_check {cfg.name} bfloat16: {bf16}")
        bf16["rule"] = f"{held[0]} <= 2 x {held[1]} + 1e-4"
        del got16, want16
    emit(
        "serve_check", config=cfg.name, layers=cfg.num_layers,
        block_pattern=list(cfg.block_pattern),
        capacity_factor=cfg.capacity_factor if cfg.num_experts else None,
        batch=b, prompt=s, patch_positions=off, decode_steps=steps,
        forms=list(forms), float32_max_abs_err=err32,
        float32_tolerance={"prefill": 2e-2, "decode": 3e-2},
        bfloat16=bf16, logit_scale=float(truth.abs().mean()),
        launches_by_design=launches,
    )
    del params, truth
    torch.cuda.empty_cache()
    return launches


def phase_serve(seed: int, with_profile: bool = False,
                cfg=qwen2_0_5b.CONFIG, b: int = SERVE_BATCH,
                phase: str = "serve", params=None, prompt: int = SERVE_PROMPT,
                max_len: int = SERVE_MAX_LEN,
                new_tokens: int = SERVE_NEW_TOKENS) -> dict:
    """A serving main path: ``b`` prompts of ``prompt`` tokens of ``cfg``
    (after the VLM's patch positions, ``frontend_inputs``) through
    ``prefill_fn`` with caches ``max_len`` deep, then greedy decoding of
    ``new_tokens`` (the first from prefill's logits, then one ``step_fn``
    call per token), as examples/serve_decode.py does. Launch counters are
    set to 0 just before and read just after; every attention layer must go
    through the bf16 designs (``wgmma`` flash, ``mma`` decode), once a
    prefill and once a step. ``with_profile``: one more decode step (into
    the cache's last slot) under the profiler. ``params``: ``cfg``'s
    parameters (``serve_params`` when None). Returns the counts: every
    kernel's launches in the run, flash launches in the prefill (and by
    design) and decode launches in the first step (and by design), the host
    clock's mean decode step after the first, its profile and the prefill's
    seconds."""
    steps = new_tokens - 1
    art = serve.build_serve_artifacts(
        cfg, ShapeConfig(f"{phase}_8k", max_len, b, "prefill")
    )
    params = serve_params(cfg, seed) if params is None else params
    inputs = {"tokens": serve_prompts(cfg, b, seed, prompt),
              **frontend_inputs(cfg, b, seed)}
    positions = prompt + (cfg.num_patches if "patch_embeds" in inputs else 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_count()
    t0 = time.perf_counter()
    logits, caches = art.prefill_fn(params, inputs)
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

    layers = attention_layers(cfg)
    if flash_per_prefill != layers:
        raise AssertionError(
            f"prefill launched flash_attention {flash_per_prefill} times, "
            f"not once per attention layer ({layers})")
    if layers and flash_mod.design(
            torch.bfloat16, cfg.resolved_head_dim) != "wgmma":
        raise AssertionError(f"{cfg.name}'s prefill is not served by wgmma")
    if flash_designs != launches_by_design(flash_mod.DESIGNS, "wgmma",
                                           layers):
        raise AssertionError(
            f"prefill's flash_attention launches by design {flash_designs}: "
            f"not all {layers} through wgmma")
    if any(n != layers for n in decode_per_step):
        raise AssertionError(
            f"decode steps launched decode_attention {decode_per_step} "
            f"times, not once per attention layer ({layers})")
    if layers and decode_mod.design(
            torch.bfloat16, cfg.resolved_head_dim) != "mma":
        raise AssertionError(f"{cfg.name}'s decode is not served by mma")
    if decode_designs != launches_by_design(decode_mod.DESIGNS, "mma",
                                            layers * steps):
        raise AssertionError(
            f"decode's launches by design {decode_designs}: not all "
            f"{layers * steps} through mma")
    if launches["flash_attention"] != layers or launches["mixing_sgd_combine"]:
        raise AssertionError(f"serving path launch counts {launches}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite decode logits")
    out = torch.cat(generated, dim=1)
    if out.shape != (b, new_tokens) or not bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()
    ):
        raise AssertionError(f"bad generated tokens {tuple(out.shape)}")
    pos = {key: c["pos"].tolist() for key, c in caches.items() if "pos" in c}
    if any(p != [positions + steps] * cfg.num_groups for p in pos.values()):
        raise AssertionError(f"cache positions after decoding: {pos}")
    cache_gb = sum(t.numel() * t.element_size()
                   for c in caches.values() for t in c.values()) / 1e9
    decode_s = sum(step_ms) / 1e3
    profiled = (
        profile_step(lambda: art.step_fn(params, caches, token), step_ms[1:])
        if with_profile else None
    )
    emit(
        phase, config=cfg.name, layers=cfg.num_layers, batch=b,
        prompt=prompt, prompt_positions=positions, max_len=max_len,
        new_tokens=new_tokens, prefill_seconds=prefill_s,
        prefill_tokens_per_s=b * positions / prefill_s,
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
            "flash_by_design": flash_designs,
            "decode_per_step": decode_per_step[0],
            "decode_by_design": decode_designs,
            "decode_step_ms_mean_after_first": float(np.mean(step_ms[1:])),
            "prefill_seconds": prefill_s, "peak_memory_gb": peak_gb,
            "profile": profiled}


def phase_serve_gemma2(seed: int) -> dict:
    """Gemma2-2B served at full width (26 layers, head_dim 256, local and
    global attention, softcap 50): ``phase_serve`` with 8 prompts, 26
    ``wgmma`` flash launches a prefill and 26 ``mma`` decode launches a
    step."""
    return phase_serve(seed, cfg=gemma2_2b.CONFIG, b=GEMMA2_SERVE_BATCH,
                       phase="serve_gemma2")


def moe_layer_check(seed: int) -> dict:
    """``moe.apply`` on the card at one Mixtral layer, full width (bf16, 8
    experts top-2, d 4096, d_ff 14336), one request of MOE_CHECK_TOKENS:

    * at capacity 4.0 (nothing dropped) against the dense oracle
      ``apply_dense_reference``, at rtol 2e-2 + 2e-2 x each token row's RMS;
    * its integer dispatch (``token_for_slot``, ``slot_for_choice``) at
      capacities 4.0 and 1.25, bit for bit the same function's on the CPU
      for the same expert choices;
    * at capacity 1.25 the output must be refused by the same limit: the
      check sees the dropped choices.

    Each token is N(0, 1) plus one vector shared by all (itself N(0, 1)),
    as a residual stream has a common component: the experts' loads then
    differ, where isotropic tokens would load all eight within a few
    percent of each other and capacity 1.25 would drop nothing."""
    cfg = MIXTRAL_CFG
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    bf16 = torch.bfloat16
    spec = {cf: moe.MoESpec(cfg.d_model, cfg.d_ff, cfg.num_experts,
                            cfg.num_experts_per_token, cf)
            for cf in (MIXTRAL_CHECK[0].capacity_factor, cfg.capacity_factor)}
    droppless, served = spec.values()
    params = moe.init(gen, droppless, bf16, "cuda")
    x = torch.randn((1, MOE_CHECK_TOKENS, cfg.d_model), generator=gen,
                    device="cuda")
    x = x.add_(torch.randn(cfg.d_model, generator=gen, device="cuda")).to(bf16)
    with torch.inference_mode():
        want = moe.apply_dense_reference(params, x, droppless, bf16)
        rms = want.float().square().mean(dim=-1, keepdim=True).sqrt()
        atol = rms.mul_(MOE_ROW_ATOL)
        got, aux = moe.apply(params, x, droppless, bf16)
        err = assert_close(got, want, MOE_ROW_RTOL,
                           "moe.apply (capacity 4.0) vs its dense oracle",
                           atol=atol)
        _, _, _, idx = moe.route(params, x, droppless)
        dispatch = {}
        for cf, sp in spec.items():
            cap = moe.capacity(MOE_CHECK_TOKENS, sp)
            on_card = moe.dispatch_indices(idx, cap, sp.num_experts)
            on_cpu = moe.dispatch_indices(idx.cpu(), cap, sp.num_experts)
            if not all(torch.equal(a.cpu(), b)
                       for a, b in zip(on_card, on_cpu)):
                raise AssertionError(f"moe dispatch at capacity {cf}: the "
                                     "card's indices differ from the CPU's")
            dispatch[str(cf)] = {
                "capacity": cap,
                "dropped_share": float(
                    (on_card[1] == sp.num_experts * cap).float().mean()),
            }
        dropped, _ = moe.apply(params, x, served, bf16)
        agree, _, worst = compare(dropped, want, MOE_ROW_RTOL, atol)
    if agree:
        raise AssertionError("moe.apply at capacity 1.25 passes for the "
                             "dense oracle: the check cannot see drops")
    out = {
        "x": list(x.shape), "dtype": "bf16", "max_abs_err": err,
        "limit": f"rtol {MOE_ROW_RTOL} + {MOE_ROW_ATOL} x row RMS",
        "dispatch_bitwise_equal_to_cpu": dispatch,
        "capacity_1.25_refused_err_over_limit": worst,
        "aux": {key: float(v) for key, v in aux.items()},
    }
    del params, x, want, got, dropped
    torch.cuda.empty_cache()
    return out


def library_attention_masked(q, k, v, mask):
    """The windowed yardstick: SDPA's memory-efficient backend with the
    window as a boolean mask (``mask`` [Sq, Sk], True = attend), k/v
    already repeated to the query heads (no flash-backend call takes a
    window)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)


def mixtral_attention_kernels(seed: int) -> dict:
    """Both attention kernels at Mixtral-8x7B's served shapes (bf16, 32
    heads / 8 KV heads, head_dim 128), held against their plain versions at
    the data-scaled limit and timed beside their bounds, plain versions and
    a library call:

    * flash at the prefill layer, q [4, 32, 8192, 128], window 4096: plain
      version on the first and the last request, with ``hold_flash_layer``'s
      controls refused (each keeps the window); the yardstick is SDPA's
      memory-efficient backend with the window as a boolean mask, k/v
      repeated to 32 heads, itself held to the kernel's output;
    * decode at the served step, q [4, 32, 1, 128] against the full
      4096-slot ring: ``length - 1`` and a dropped tile refused; kernel and
      SDPA (flash backend, the ring's length) replayed from a CUDA graph."""
    cfg = MIXTRAL_CFG
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    b, h, kv = MIXTRAL_SERVE_BATCH, cfg.num_heads, cfg.num_kv_heads
    d, window, bf16 = cfg.resolved_head_dim, cfg.sliding_window, torch.bfloat16
    q, k, v = attn_inputs(gen, b, h, kv, SERVE_PROMPT, SERVE_PROMPT, d, bf16)
    res, refused = hold_flash_layer(
        f"flash Mixtral-8x7B prefill layer q={list(q.shape)} "
        f"k={list(k.shape)} bf16 window={window}", q, k, v,
        requests=(0, b - 1), window=window)
    if res["design"] != "wgmma":
        raise AssertionError(f"{res['case']} ran {res['design']}")
    timed = time_flash_layer(q, k, v, window=window)

    def plain_by_request():
        for i in range(b):
            ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    window=window)

    plain_ms = time_cuda(plain_by_request, reps=2)
    mask = attention.causal_mask(SERVE_PROMPT, SERVE_PROMPT, window, "cuda")
    kk, vv = repeat_kv(k, h), repeat_kv(v, h)
    lib_out = library_attention_masked(q, kk, vv, mask)
    lib_held = hold("SDPA (efficient, window mask) vs the flash kernel",
                    lib_out, ops.flash_attention(q, k, v, window=window),
                    scaled=True)
    del lib_out
    lib_ms = time_cuda(lambda: library_attention_masked(q, kk, vv, mask),
                       reps=TIMING_REPS)
    flash = {
        "case": "Mixtral-8x7B prefill layer (window 4096)",
        "q": list(q.shape), "k": list(k.shape), "window": window,
        "design": res["design"], "max_abs_err": res["max_abs_err"],
        "largest_err_over_limit": res["largest_err_over_limit"],
        **timed, "plain_ms": plain_ms,
        "plain_note": f"plain version run request by request, {b} calls",
        "library_ms": lib_ms, "ms_over_library_ms": timed["ms"] / lib_ms,
        "library_call": "scaled_dot_product_attention(attn_mask=window "
                        "mask), efficient backend, k/v repeated to 32 heads",
        "library_vs_kernel_max_abs_err": lib_held["max_abs_err"],
    }
    del q, k, v, kk, vv, mask
    torch.cuda.empty_cache()

    q, k, v = attn_inputs(gen, b, h, kv, 1, window, d, bf16)
    _, refusals, decode = hold_decode_step(
        "Mixtral-8x7B served step (4096-slot ring)", q, k, v, window,
        decode_mod.tile_slots(bf16, d))
    refused += refusals
    del q, k, v
    torch.cuda.empty_cache()
    emit("mixtral_attention", flash=flash, decode=decode, refused=refused)
    return {"flash_attention": flash, "decode_attention": decode}


def decode_step_bytes(cfg, params, caches, b: int) -> dict:
    """Bytes one decode step must move at least: every block weight once
    (the vectorized dispatch multiplies every expert's weights each step,
    whatever the routing), the final norm and the LM head's table, ``b``
    rows of the embedding, every cache tensor (K/V at their full depth,
    the recurrent states) read once; and the expert weights alone."""
    leaf_bytes = {path: t.numel() * t.element_size()
                  for path, t in tree_paths(params)}
    table = "embed/table" if cfg.tie_embeddings else "unembed/table"
    embed_row = params["embed"]["table"][0]
    total = (sum(v for p, v in leaf_bytes.items() if p.startswith("blocks/"))
             + leaf_bytes["final_norm/scale"] + leaf_bytes[table]
             + b * embed_row.numel() * embed_row.element_size()
             + sum(t.numel() * t.element_size()
                   for c in caches.values() for t in c.values()))
    experts = sum(v for p, v in leaf_bytes.items()
                  if p.rsplit("/", 1)[-1] in ("gate", "up", "down")
                  and "/ffn/" in p)
    return {"bytes": total, "expert_bytes": experts}


def prefill_drop_shares(art, params, tokens):
    """The share of (token, choice) pairs that the capacity drops in each
    MoE layer of one prefill of ``tokens``: an untimed prefill with
    ``moe.apply`` wrapped to route each layer's input once more and count
    the choices ``dispatch_indices`` leaves without a slot. Returns (the
    shares by layer, the prefill's logits and caches)."""
    shares = []
    real = moe.apply

    def counting(p, x, spec, cdt, with_aux=True):
        cap = moe.capacity(x.shape[1], spec)
        _, _, _, idx = moe.route(p, x.to(cdt), spec)
        _, slot_for_choice = moe.dispatch_indices(idx, cap, spec.num_experts)
        shares.append((slot_for_choice == spec.num_experts * cap)
                      .float().mean())
        return real(p, x, spec, cdt, with_aux)

    moe.apply = counting
    out = art.prefill_fn(params, {"tokens": tokens})
    moe.apply = real
    return [float(share) for share in shares], out


def mixtral_step_and_drops(params, seed: int, host_step_ms: float) -> dict:
    """After the served run, on its prompts: the prefill's dropped share by
    layer (``prefill_drop_shares``), then one decode step replayed from a
    CUDA graph (the device's time; each replay advances every ring by one
    token, as a step does) beside the step's byte bound, and the share of
    it that this time and ``host_step_ms`` (the host clock's) reach."""
    cfg, b = MIXTRAL_CFG, MIXTRAL_SERVE_BATCH
    art = serve.build_serve_artifacts(
        cfg, ShapeConfig("serve_mixtral_8k", SERVE_MAX_LEN, b, "prefill"))
    drops, (logits, caches) = prefill_drop_shares(
        art, params, serve_prompts(cfg, b, seed))
    if len(drops) != cfg.num_layers:
        raise AssertionError(f"{len(drops)} MoE layers in the prefill")
    token = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    device_ms = time_graph(lambda: art.step_fn(params, caches, token),
                           reps=1, replays=10)
    moved = decode_step_bytes(cfg, params, caches, b)
    bound = moved["bytes"] / PEAK_BYTES_PER_S * 1e3
    out = {
        "prefill_dropped_share_by_layer": drops,
        "capacity_factor": cfg.capacity_factor,
        "decode_step_device_ms": device_ms,
        "decode_step_device_timing": "one step_fn call replayed from a CUDA "
                                     "graph, mean of 10 replays",
        "decode_step_host_ms": host_step_ms,
        "decode_step_bound_ms": bound, "decode_step_bound_by": "bytes",
        "decode_step_bytes": moved["bytes"],
        "decode_step_expert_bytes": moved["expert_bytes"],
        "decode_step_expert_bound_ms":
            moved["expert_bytes"] / PEAK_BYTES_PER_S * 1e3,
        "decode_step_share_of_bound_host": bound / host_step_ms,
        "decode_step_share_of_bound_device": bound / device_ms,
    }
    emit("serve_mixtral_step", **out)
    del logits, caches
    torch.cuda.empty_cache()
    return out


def phase_serve_mixtral(seed: int, with_profile: bool = False) -> dict:
    """Mixtral-8x7B (MIXTRAL_CFG: 16 layers, full width, MoE FFN on every
    layer, head_dim 128, window 4096) on one card:

    * ``moe.apply`` at one full-width layer (``moe_layer_check``);
    * both attention kernels at its served shapes
      (``mixtral_attention_kernels``);
    * ``serve_check`` at capacity 4.0 in float32 at MIXTRAL_CHECK_FP32_LAYERS
      layers (the ``ffma`` designs at D = 128 with the window, in a model);
    * the served path: ``phase_serve`` with 4 prompts of 8192 tokens and
      64 greedy tokens — 16 ``wgmma`` flash launches a prefill and 16
      ``mma`` decode launches a step asserted (``with_profile``: one more
      decode step under the profiler) — then ``mixtral_step_and_drops``;
    * ``serve_check`` at capacity 4.0 in bf16 at the served 16 layers, on
      the served run's parameters.

    Returns the launch counts and timings of the served run, the kernels'
    entries at its shapes, and the checks' results."""
    t0 = time.perf_counter()
    layer = moe_layer_check(seed)
    emit("moe_layer_check", **layer)
    kernels = mixtral_attention_kernels(seed)
    check_cfg, b, s = MIXTRAL_CHECK
    checks = phase_serve_check(
        seed, dataclasses.replace(check_cfg,
                                  num_layers=MIXTRAL_CHECK_FP32_LAYERS),
        b, s, forms=("float32",))
    params = serve_params(MIXTRAL_CFG, seed)
    run = phase_serve(seed, with_profile, cfg=MIXTRAL_CFG,
                      b=MIXTRAL_SERVE_BATCH, phase="serve_mixtral",
                      params=params)
    step = mixtral_step_and_drops(
        params, seed, run["decode_step_ms_mean_after_first"])
    checks.update(phase_serve_check(seed, check_cfg, b, s,
                                    forms=("bfloat16",), params=params))
    del params
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit("serve_mixtral_total", seconds=seconds)
    return {**run, **step, "kernels": kernels, "moe_layer": layer,
            "serve_checks": checks, "seconds": seconds}


def served_attention_kernels(seed: int, name: str, cfg, b: int, s: int,
                             depth: int) -> dict:
    """Both attention kernels at a served model's shapes (bf16, causal, no
    window): flash at its prefill layer, q ``[b, H, s, D]``, held against
    its plain version on the first and the last request at the data-scaled
    limit (``hold_flash_layer``, the plain version 4096 query rows at a
    time, its controls refused, a key tile left out among them), timed
    beside its bound, the plain version (request by request) and SDPA
    (flash backend, ``enable_gqa``), itself held to the kernel's output;
    decode at its served step against the cache ``[b, KV, depth, D]`` full
    (``hold_decode_step``: ``length - 1`` and a dropped tile refused; kernel
    and SDPA replayed from a CUDA graph)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    q, k, v = attn_inputs(gen, b, h, kv, s, s, d, bf16)
    bn = flash_mod.wgmma_tile(d).bn
    res, refused = hold_flash_layer(
        f"flash {name} prefill layer q={list(q.shape)} k={list(k.shape)} "
        "bf16", q, k, v, requests=(0, b - 1), drop_tile=s * 3 // 4 // bn * bn,
        tile=bn, row_block=4096)
    if res["design"] != "wgmma":
        raise AssertionError(f"{res['case']} ran {res['design']}")
    timed = time_flash_layer(q, k, v)

    def plain_by_request():
        for i in range(b):
            for r0 in range(0, s, 4096):
                faulty_flash_plain(q[i:i + 1, :, r0:r0 + 4096], k[i:i + 1],
                                   v[i:i + 1], None, r0)

    plain_ms = time_cuda(plain_by_request, reps=1, warmup=0)
    lib_held = hold("SDPA (flash, enable_gqa) vs the flash kernel",
                    library_attention(q, k, v, True), ops.flash_attention(
                        q, k, v), scaled=True)
    lib_ms = time_cuda(lambda: library_attention(q, k, v, True),
                       reps=TIMING_REPS)
    flash = {
        "case": f"{name} prefill layer (causal)", "q": list(q.shape),
        "k": list(k.shape), "design": res["design"],
        "max_abs_err": res["max_abs_err"],
        "largest_err_over_limit": res["largest_err_over_limit"],
        **timed, "plain_ms": plain_ms,
        "plain_note": f"plain version run request by request, 4096 query "
                      f"rows at a time, {b} requests",
        "library_ms": lib_ms, "ms_over_library_ms": timed["ms"] / lib_ms,
        "library_call": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), flash backend",
        "library_vs_kernel_max_abs_err": lib_held["max_abs_err"],
    }
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = attn_inputs(gen, b, h, kv, 1, depth, d, bf16)
    _, refusals, decode = hold_decode_step(
        f"{name} served step (cache {depth} deep, full)", q, k, v, depth,
        decode_mod.tile_slots(bf16, d))
    refused += refusals
    del q, k, v
    torch.cuda.empty_cache()
    emit("served_attention", config=name, flash=flash, decode=decode,
         refused=refused)
    return {"flash_attention": flash, "decode_attention": decode}


def decode_step_bound(cfg, params, caches, b: int, step_ms: float) -> dict:
    """A decode step's byte bound (``decode_step_bytes`` at 3.35 TB/s) and
    the share of it that ``step_ms`` (the host clock's) reaches."""
    moved = decode_step_bytes(cfg, params, caches, b)
    bound = moved["bytes"] / PEAK_BYTES_PER_S * 1e3
    return {"decode_step_bytes": moved["bytes"],
            "decode_step_expert_bytes": moved["expert_bytes"],
            "decode_step_bound_ms": bound, "decode_step_bound_by": "bytes",
            "decode_step_share_of_bound_host": bound / step_ms}


def serve_model(seed: int, phase: str, cfg, served, check, kernels=None,
                check_fp32=None, with_profile: bool = False,
                forms=("bfloat16",), layer_times=None) -> dict:
    """One model of the zoo on the card: its attention kernels at the
    served shapes (``kernels``: (flash's sequence, decode's depth)) and a
    float32 ``serve_check`` (``check_fp32``: (cfg, b, s), float32
    parameters drawn as such) before its parameters are drawn; then the
    served run (``served``: batch, prompt, cache depth, new tokens) with a
    decode step's byte bound (its caches' shapes at full depth), and
    ``serve_check`` (``check``: (cfg, b, s) in ``forms``) on the served
    run's parameters; ``layer_times(params)``, when given, between the
    two."""
    t0 = time.perf_counter()
    b, prompt, max_len, new_tokens = served
    out = {"kernels": None, "serve_checks": {}}
    if kernels is not None:
        out["kernels"] = served_attention_kernels(seed, cfg.name, cfg, b,
                                                  *kernels)
    if check_fp32 is not None:
        out["serve_checks"].update(phase_serve_check(
            seed, *check_fp32, forms=("float32",)))
    params = serve_params(cfg, seed)
    run = phase_serve(seed, with_profile, cfg=cfg, b=b, phase=phase,
                      params=params, prompt=prompt, max_len=max_len,
                      new_tokens=new_tokens)
    art = serve.build_serve_artifacts(
        cfg, ShapeConfig(phase, max_len, b, "prefill"), device="cuda")
    bound = decode_step_bound(cfg, params, art.cache_shapes, b,
                              run["decode_step_ms_mean_after_first"])
    if run["profile"] is not None:
        bound["decode_step_share_of_bound_device_busy"] = (
            bound["decode_step_bound_ms"] / run["profile"]["device_busy_ms"])
    emit(f"{phase}_step", **bound)
    if layer_times is not None:
        out["layer_times"] = layer_times(params)
        emit(f"{phase}_layer_times", **out["layer_times"])
    check_cfg, cb, cs = check
    out["serve_checks"].update(phase_serve_check(
        seed, check_cfg, cb, cs, forms=forms, params=params))
    del params
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit(f"{phase}_total", seconds=seconds)
    return {**run, **bound, **out, "seconds": seconds}


def phase_serve_jamba(seed: int) -> dict:
    """Jamba-1.5-Large (JAMBA_CFG: its first 5 layers at full width) on
    one card: both attention kernels at its shapes (q ``[2, 64, 8192, 128]``
    causal NoPE; decode at group 8 over the 8224-deep cache); the float32
    ``serve_check`` at layers 3-4 (the ``ffma`` designs at group 8, D =
    128); the served run, 2 prompts of 8192 tokens and 32 greedy tokens,
    1 ``wgmma`` flash launch a prefill and 1 ``mma`` decode launch a step
    asserted, one more step under the profiler (the device's time: a
    graph replay would write past the cache); the bf16 ``serve_check`` at
    the served 5 layers at capacity 8.0."""
    _, prompt, max_len, _ = JAMBA_SERVE
    return serve_model(
        seed, "serve_jamba", JAMBA_CFG, JAMBA_SERVE, JAMBA_CHECK,
        kernels=(prompt, max_len),
        check_fp32=(JAMBA_CHECK_FP32, JAMBA_CHECK[1], JAMBA_CHECK[2]),
        with_profile=True,
        layer_times=lambda params: jamba_layer_times(params, seed))


def jamba_layer_times(params, seed: int) -> dict:
    """Where Jamba's prefill goes, by block part, at the served prompt (2 x
    8192 tokens of N(0, 1) activations in bf16) on the served weights: the
    Mamba mixer of layer 0 (``ssm.mamba_prefill``: projections, conv,
    gates and the chunked scan's loop of 8192 steps), the MoE FFN of layer
    1 (``moe.apply``, capacity 1.25) and the dense FFN of layer 0; each by
    CUDA events over 2 calls after a warm-up, and the Mamba mixer also on
    the host clock (its loop issues one launch a step)."""
    cfg, bf16 = JAMBA_CFG, torch.bfloat16
    b, s = JAMBA_SERVE[:2]
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(bf16)
    layer0 = tree_map(lambda t: t[0], params["blocks"]["b0_mamba"])
    moe1 = tree_map(lambda t: t[0], params["blocks"]["b1_mamba_moe"]["ffn"])
    spec = blocks._mamba_spec(cfg)
    with torch.inference_mode():
        mixer = lambda: ssm.mamba_prefill(layer0["mixer"], x, spec, bf16)
        mixer_ms = time_cuda(mixer, reps=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mixer()
        torch.cuda.synchronize()
        mixer_host_ms = (time.perf_counter() - t0) * 1e3
        out = {
            "tokens": b * s,
            "mamba_mixer_ms": mixer_ms,
            "mamba_mixer_host_ms": mixer_host_ms,
            "mamba_scan_steps": s,
            "moe_ffn_ms": time_cuda(lambda: moe.apply(
                moe1, x, blocks._moe_spec(cfg), bf16, False), reps=2),
            "dense_ffn_ms": time_cuda(lambda: mlp_apply(
                layer0["ffn"], x, bf16), reps=2),
        }
    del x
    torch.cuda.empty_cache()
    return out


def phase_serve_xlstm(seed: int) -> dict:
    """xLSTM-125M whole on one card: 8 prompts of 2048 tokens and 64 greedy
    tokens through mLSTM's parallel form and sLSTM's loop, no attention and
    so no kernel launch asserted; ``serve_check`` in float32 and bf16."""
    return serve_model(seed, "serve_xlstm", xlstm_125m.CONFIG, XLSTM_SERVE,
                       XLSTM_CHECK, forms=("float32", "bfloat16"))


def phase_serve_llava(seed: int) -> dict:
    """LLaVA-NeXT-34B at full width and 8 of its 60 layers: both kernels at
    its shapes (q ``[4, 56, 4096, 128]``, group 7, decode rounded to 8),
    then 4 requests of 576 patch positions and 3520 tokens, 32 greedy
    tokens, 8 + 8 launches asserted; bf16 ``serve_check`` with patches."""
    _, prompt, max_len, _ = LLAVA_SERVE
    positions = LLAVA_CFG.num_patches + prompt
    return serve_model(seed, "serve_llava", LLAVA_CFG, LLAVA_SERVE,
                       LLAVA_CHECK, kernels=(positions, max_len))


def phase_serve_musicgen(seed: int) -> dict:
    """MusicGen-large whole (48 layers, multi-head attention at D = 64):
    both kernels at its shapes (q ``[8, 32, 1500, 64]``, group 1, decode
    rounded to 2), then 8 requests of 1500 codec tokens and 64 greedy
    tokens, 48 + 48 launches asserted; bf16 ``serve_check``."""
    _, prompt, max_len, _ = MUSICGEN_SERVE
    return serve_model(seed, "serve_musicgen", musicgen_large.CONFIG,
                       MUSICGEN_SERVE, MUSICGEN_CHECK,
                       kernels=(prompt, max_len))


def add_served(flash: dict, decode: dict, key: str, run: dict) -> None:
    """A served model's run (``phase_serve_mixtral``, ``serve_model``) into
    the attention kernels' entries of the kernels line, under ``key``: its
    shapes, its served run's launches (by prefill, step and design) and its
    ``serve_check`` runs' launches by design."""
    for kernel in (flash, decode):
        name = kernel["name"]
        if run["kernels"] is not None:
            kernel["shapes"].append(run["kernels"][name])
        kernel[f"launches_{key}"] = run["launches"][name]
        kernel[f"launches_{key}_serve_checks"] = {
            form: by_kernel[name]
            for form, by_kernel in run["serve_checks"].items()}
    flash[f"launches_{key}_per_prefill"] = run["flash_per_prefill"]
    flash[f"launches_{key}_by_design"] = run["flash_by_design"]
    decode[f"launches_{key}_per_step"] = run["decode_per_step"]
    decode[f"launches_{key}_by_design"] = run["decode_by_design"]


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


def live_pairs(q, window=None) -> int:
    """Live causal (window) (query, key) pairs of ``q [B,H,Sq,D]`` with
    Sk == Sq, over every batch entry and head."""
    b, h, sq, _ = q.shape
    return b * h * sum(min(i + 1, window or i + 1) for i in range(sq))


def flash_flops(q, window=None) -> int:
    """4·D flops per live causal (window) (query, key) pair."""
    return 4 * q.shape[-1] * live_pairs(q, window)


@functools.lru_cache(maxsize=None)
def mufu_per_s() -> float:
    """MUFU results a second of torch's device 0: MUFU_PER_CLOCK_PER_SM x
    its SMs x its max SM clock as nvidia-smi reads it, the card picked by
    its UUID (nvidia-smi's indices ignore CUDA_VISIBLE_DEVICES)."""
    props = torch.cuda.get_device_properties(0)
    uuid = str(props.uuid).lower().removeprefix("gpu-")
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    mhz = {r.split(",")[0].strip().lower().removeprefix("gpu-"):
           float(r.split(",")[1]) for r in rows}
    if uuid not in mhz:
        raise AssertionError(f"nvidia-smi lists no card with UUID {uuid}: "
                             f"{rows}")
    return MUFU_PER_CLOCK_PER_SM * props.multi_processor_count * mhz[uuid] * 1e6


def library_attention_f32(q, k, v, causal: bool):
    """The float32 yardstick: SDPA's memory-efficient backend (the flash
    backend takes no float32) with TF32 off, on k/v already repeated to
    the query heads (``repeat_kv``, outside the timing)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal
        )


def repeat_kv(t, heads: int):
    return t.repeat_interleave(heads // t.shape[1], dim=1)


def flash_bound(q, k, window=None, softcap=None) -> dict:
    """Least ms of a flash layer, the largest of three times: the live
    pairs' flops at the peak of q's type (``"tensor"``: bf16 on the tensor
    cores; ``"ffma"``: float32, TF32 being off), the fp32 ex2 the kernels
    issue on the MUFU (``"mufu_ex2_f32"``: one a live pair, one tanh more
    with a softcap, at ``mufu_per_s()``; the bound of that instruction, not
    the card's least time for exponentials), and q, k, v, o moved once at
    the memory rate (``"bytes"``). ``bound_by`` is "operations" or
    "bytes", ``bound_unit`` the one of the three that binds; all three are
    in ``bound_ms_by``."""
    pairs = live_pairs(q, window)
    bf16 = q.dtype == torch.bfloat16
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    times = {
        "tensor" if bf16 else "ffma":
            4 * q.shape[-1] * pairs
            / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS) * 1e3,
        "mufu_ex2_f32": pairs * (2 if softcap else 1) / mufu_per_s() * 1e3,
        "bytes": moved / PEAK_BYTES_PER_S * 1e3,
    }
    unit = max(times, key=times.get)
    return {"bound_ms": times[unit],
            "bound_by": "bytes" if unit == "bytes" else "operations",
            "bound_unit": unit, "bound_ms_by": times}


def bound_shares(bound: dict, ms: float) -> dict:
    """The share of ``flash_bound``'s binding time that ``ms`` reaches,
    and the share of each of its three times."""
    return {"share_of_bound": bound["bound_ms"] / ms,
            "share_of_bound_by": {unit: t / ms for unit, t
                                  in bound["bound_ms_by"].items()}}


def decode_bound(q, k, length: int) -> tuple[float, str]:
    """Least ms: K and V up to ``length`` plus q and o moved once."""
    b, kv, _, d = k.shape
    moved = (2 * b * kv * length * d + 2 * q.numel()) * q.element_size()
    return moved / PEAK_BYTES_PER_S * 1e3, "bytes"


def tile_dropped_plain(q, k, v, length: int, start: int,
                       tile: int = DECODE_TILE, softcap=None):
    """The plain decode version with cache slots ``start`` ..
    ``start + tile - 1`` left out (a kernel that skips one tile)."""
    s, dev = k.shape[2], k.device
    keep = torch.cat([torch.arange(start, device=dev),
                      torch.arange(start + tile, s, device=dev)])
    return ref.decode_attention_ref(
        q, k.index_select(2, keep), v.index_select(2, keep), length - tile,
        softcap=softcap)


def head_mod_decode_plain(q, k, v, length, softcap=None):
    """The plain decode version with query head h on KV head h % KV."""
    h, kv = q.shape[1], k.shape[1]
    heads = torch.tensor([i % kv for i in range(h)], device=q.device)
    return ref.decode_attention_ref(q, k.index_select(1, heads),
                                    v.index_select(1, heads), length,
                                    softcap=softcap)


def hold_decode_step(name: str, q, k, v, length: int, tile: int):
    """A bf16 decode step at a main path's shape: the kernel against its
    plain version at the data-scaled limit, ``length - 1`` and a plain
    version without one ``tile`` of the cache refused, then its time and
    SDPA's (flash backend, ``enable_gqa``) replayed from a CUDA graph and
    eager, its plain version's time and its byte bound. Returns (the
    check's result, the refusals, the shape's entry)."""
    b, h = q.shape[:2]
    kv, d = k.shape[1], k.shape[3]
    n = torch.tensor(length, dtype=torch.int32, device="cuda")
    what = f"decode {name} q={list(q.shape)} k={list(k.shape)} bf16"
    res, got = check_decode(f"{what} length={length}", q, k, v, n,
                            scaled=True)
    start = length // 2 // tile * tile
    refused = [
        refuse(f"a decode plain version with length - 1 ({name})", got,
               ref.decode_attention_ref(q, k, v, n - 1), scaled=True),
        refuse(f"a decode plain version without cache slots {start} .. "
               f"{start + tile - 1} ({name})", got,
               tile_dropped_plain(q, k, v, n, start, tile), scaled=True),
    ]
    del got
    torch.cuda.empty_cache()

    def kernel():
        return ops.decode_attention(q, k, v, n)

    def library():
        return library_attention(q, k, v, False)

    ms = time_graph(kernel, reps=TIMING_REPS)
    lib_ms = time_graph(library, reps=TIMING_REPS)
    bound, by = decode_bound(q, k, length)
    entry = {
        "case": name, "q": list(q.shape), "k": list(k.shape),
        "length": length, "design": res["design"],
        "splits": decode_mod.split_plan(
            b, kv, length,
            torch.cuda.get_device_properties(0).multi_processor_count,
            decode_mod.resident_blocks(q.dtype, d, h // kv, q.device),
            tile)[1],
        "max_abs_err": res["max_abs_err"],
        "largest_err_over_limit": res["largest_err_over_limit"], "ms": ms,
        "plain_ms": time_cuda(lambda: ref.decode_attention_ref(q, k, v, n),
                              reps=TIMING_REPS),
        "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
        "share_of_bound": bound / ms,
        "achieved_bytes_per_s": bound * PEAK_BYTES_PER_S / ms,
        "eager_ms": time_cuda(kernel, reps=TIMING_REPS),
        "library_eager_ms": time_cuda(library, reps=TIMING_REPS),
        "ms_over_library_ms": ms / lib_ms,
    }
    return res, refused, entry


def graph_replays(fn, want, replays: int = 3) -> int:
    """``fn()`` captured once in a CUDA graph and replayed ``replays``
    times in a row, its output overwritten with NaN before each replay:
    every replay must give ``want`` (the eager output) bit for bit. A
    decode launch combines its splits on arrival counters that its last
    blocks set back to 0, so this fails if one is left behind."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for i in range(replays):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"graph replay {i + 1} differs from the "
                                 "eager output")
    del graph
    return replays


def kernel_device_us(fn, calls: int = 50) -> dict:
    """Mean device microseconds of each kernel that ``fn()`` launches, by
    its function name (torch.profiler over ``calls`` eager calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = re.search(r"(\w+)(<[^>]*>)?\(", ev.key)
        if ev.device_time_total > 0 and ev.count:
            key = "".join(name.groups("")) if name else ev.key
            out[key] = {"us": ev.device_time_total / ev.count,
                        "launches": ev.count}
    return out


def decode_step_times(q, k, v, depth: int, softcap) -> dict:
    """A decode step timed as its check runs it (with its softcap): the
    launch replayed from a CUDA graph beside its byte bound, with the cache
    warm in L2 as the repeated call leaves it (``ms``) and cold
    (``cold_ms``: the graph cycles through copies of K and V, twice the L2
    in all, so each launch finds its cache evicted, as a model's layers
    do); each kernel it launches apart (``kernel_device_us``); the same
    launch at length 1 (the floor of one launch's fixed costs); and the
    split plan: tiles, splits, blocks and the share of the SMs those
    occupy."""
    b, h = q.shape[:2]
    kv, d = k.shape[1], k.shape[3]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = decode_mod.resident_blocks(q.dtype, d, h // kv, q.device)
    tile = decode_mod.tile_slots(q.dtype, d)
    tiles, splits = decode_mod.split_plan(b, kv, depth, sms, resident, tile)
    blocks = b * kv * splits

    def step(n: int, kk=k, vv=v):
        length = torch.tensor(n, dtype=torch.int32, device=q.device)
        return lambda: ops.decode_attention(q, kk, vv, length, softcap=softcap)

    ms = time_graph(step(depth), reps=TIMING_REPS)
    bound, by = decode_bound(q, k, depth)
    cache_bytes = 2 * k.numel() * k.element_size()
    copies = min(128, max(2, math.ceil(2 * L2_BYTES / cache_bytes)))
    cold_ms = time_graph_cycle([step(depth, k.clone(), v.clone())
                                for _ in range(copies)])
    return {
        "ms": ms, "cold_ms": cold_ms, "cold_copies": copies,
        "bound_ms": bound, "bound_by": by,
        "share_of_bound_cold": bound / cold_ms,
        "length_1_ms": time_graph(step(1), reps=TIMING_REPS),
        "kernel_us": kernel_device_us(step(depth)),
        "tile": tile, "tiles": tiles, "splits": splits, "blocks": blocks,
        "resident_blocks_per_sm": resident,
        "sm_share": min(blocks, sms) / sms,
    }


def decode_ffma_times(seed: int) -> list[dict]:
    """The float32 decode steps of both SERVE_CHECKS configs (the global
    cache at its last teacher-forced depth) timed alone by
    ``decode_step_times``, no check: the one measurement of the ffma decode
    design that also runs against an earlier tree of the package, to
    compare designs in one call."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    rows = []
    for cfg, b, s in SERVE_CHECKS:
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = attn_inputs(gen, b, h, kv, 1, s + CHECK_STEPS, d,
                              torch.float32)
        rows.append({
            "config": cfg.name, "q": list(q.shape), "k": list(k.shape),
            "softcap": cfg.attn_logit_softcap,
            **decode_step_times(q, k, v, s + CHECK_STEPS,
                                cfg.attn_logit_softcap),
        })
        del q, k, v
    emit("decode_ffma_times", steps=rows)
    return rows


def hold_flash_layer(what, q, k, v, requests, window=None, softcap=None,
                     drop_tile: int | None = None,
                     tile: int = WGMMA_D256_TILE, row_block=None):
    """A main-path flash layer against its plain version (``check_flash``:
    on ``requests`` at the data-scaled limit, or with ``requests=None`` on
    the whole batch at the tables' tolerance), and the faulty plain
    versions that limit must refuse on request 0's later half of query
    rows (each keeps the layer's window and softcap): ``kv = h % KV``, the
    causal diagonal excluded and, with ``drop_tile``, keys ``drop_tile`` ..
    ``drop_tile + tile - 1`` left out; without GQA (H = KV) or at one KV
    head, where ``kv = h % KV`` is no fault, only the other two. ``row_block``: as
    ``check_flash``. Returns (result, refusals)."""
    res, got = check_flash(what, q, k, v, window, softcap, requests=requests,
                           row_block=row_block)
    row0 = q.shape[2] // 2
    faults = [("the causal diagonal excluded", "strict_causal")]
    if q.shape[1] != k.shape[1] and k.shape[1] > 1:
        faults.insert(0, ("kv = h % KV", "head_mod"))
    if drop_tile is not None:
        faults.append((f"keys {drop_tile} .. {drop_tile + tile - 1}"
                       " left out (one key tile)", ("drop", drop_tile, tile)))
    refused = []
    for text, fault in faults:
        bad = faulty_flash_plain(q[:1, :, row0:], k[:1], v[:1], fault, row0,
                                 window, softcap)
        refused.append(refuse(
            f"a flash plain version with {text} ({what}, request 0, query "
            f"rows from {row0})", got[:1, :, row0:], bad,
            scaled=requests is not None))
        del bad
    del got
    torch.cuda.empty_cache()
    return res, refused


def time_flash_layer(q, k, v, window=None, softcap=None) -> dict:
    """The kernel's time at a layer beside its bound (and the share of it
    reached) and live TFLOP/s."""
    ms = time_cuda(lambda: ops.flash_attention(q, k, v, window=window,
                                               softcap=softcap),
                   reps=TIMING_REPS)
    bound = flash_bound(q, k, window, softcap)
    return {"ms": ms, **bound, **bound_shares(bound, ms),
            "live_tflops_per_s": flash_flops(q, window) / (ms * 1e-3) / 1e12}


def gemma2_inputs(gen, batch: int):
    cfg = gemma2_2b.CONFIG
    return attn_inputs(gen, batch, cfg.num_heads, cfg.num_kv_heads,
                       SERVE_PROMPT, SERVE_PROMPT, cfg.resolved_head_dim,
                       torch.bfloat16)


def gemma2_layer_times(seed: int) -> list[dict]:
    """Gemma2-2B's two prefill layers (GEMMA2_LAYERS, bf16, softcap 50)
    timed alone, no check: the one measurement that also runs against an
    earlier tree of the package, to compare designs in one call."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    cap = gemma2_2b.CONFIG.attn_logit_softcap
    out = []
    for name, batch, window in GEMMA2_LAYERS:
        q, k, v = gemma2_inputs(gen, batch)
        out.append({
            "case": f"Gemma2-2B {name} layer", "q": list(q.shape),
            "k": list(k.shape), "window": window, "softcap": cap,
            "design": flash_mod.design(q.dtype, q.shape[-1]),
            **time_flash_layer(q, k, v, window, cap),
        })
        del q, k, v
        torch.cuda.empty_cache()
    emit("gemma2_layer_times", layers=out)
    return out


def phase_attention_kernels(seed: int, serve_run: dict | None = None,
                            gemma2_run: dict | None = None) -> list[dict]:
    """The attention kernels at the main paths' shapes, each held against
    its plain version at the data-scaled limit (``attn_limit``) and timed
    with its plain version and one library call:

    * Qwen2-0.5B's prefill layer, plain version on the first and the last
      request (a full-batch fp32 logit tensor would be 120 GB); the limit
      refuses, on the query rows of the later half, a plain version with
      ``kv = h % KV`` and one with the causal diagonal excluded;
    * a head_dim-128 layer, Mixtral-8x7B's 32 heads / 8 KV heads at batch
      4, with the same controls and SDPA's time beside the kernel's;
    * the wgmma design at head_dim 32 and 16 (q [4, 8, 4096, D], causal)
      on two requests, with the same two controls and a third that leaves
      one 128-key tile out, and its plain version's and SDPA's time beside
      the kernel's and its bound (the MUFU's ex2);
    * the served decode step and DECODE_32K's decode layer (also with
      ragged [B] lengths); at both, the limit refuses a plain version with
      ``length - 1`` and one with a tile of the cache left out;
    * Gemma2-2B's local layer (window 4096, softcap 50, 2 requests) and
      global layer (causal, softcap 50, 8 requests), plain version on the
      first and last request, with the same two controls and a third that
      leaves one 64-key tile out, each keeping window and softcap; timed
      beside their bounds (no library call computes a softcap).

    ``serve_run`` / ``gemma2_run``: ``phase_serve``'s counts of the two
    served models, put in the entries; without them the entries carry no
    launch counts."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    cfg = qwen2_0_5b.CONFIG
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    cases, refused = [], []

    q, k, v = attn_inputs(gen, SERVE_BATCH, h, kv, SERVE_PROMPT,
                          SERVE_PROMPT, d, bf16)
    res, refusals = hold_flash_layer(
        f"flash Qwen2-0.5B prefill layer q={list(q.shape)} "
        f"k={list(k.shape)} bf16", q, k, v, requests=(0, SERVE_BATCH - 1))
    cases.append(res)
    refused += refusals
    flash_ms = time_cuda(lambda: ops.flash_attention(q, k, v),
                         reps=TIMING_REPS)

    def plain_by_request():
        for i in range(q.shape[0]):
            ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1])

    flash_plain_ms = time_cuda(plain_by_request, reps=2)
    flash_lib_ms = time_cuda(lambda: library_attention(q, k, v, True),
                             reps=TIMING_REPS)
    bound = flash_bound(q, k)
    flash = {
        **kernel_fields("flash_attention"),
        "design": res["design"],
        "max_abs_err": res["max_abs_err"], "ms": flash_ms,
        "plain_ms": flash_plain_ms, **bound,
        **bound_shares(bound, flash_ms),
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

    # head_dim 128: Mixtral-8x7B's attention layer (32 heads, 8 KV heads)
    # at batch 4, causal without its window (kept for comparison with the
    # earlier records; phase_serve_mixtral holds and times the served,
    # windowed layer), with the same controls and its library time.
    b128 = 4
    q, k, v = attn_inputs(gen, b128, 32, 8, SERVE_PROMPT, SERVE_PROMPT, 128,
                          bf16)
    res, refusals = hold_flash_layer(
        f"flash head_dim-128 layer q={list(q.shape)} k={list(k.shape)} bf16",
        q, k, v, requests=(0, b128 - 1))
    cases.append(res)
    refused += refusals
    ms128 = time_cuda(lambda: ops.flash_attention(q, k, v), reps=TIMING_REPS)
    lib128 = time_cuda(lambda: library_attention(q, k, v, True),
                       reps=TIMING_REPS)
    bound128 = flash_bound(q, k)
    flash["shapes"] = [{
        "case": "head_dim-128 layer (Mixtral-8x7B, batch 4)",
        "q": list(q.shape), "k": list(k.shape), "design": res["design"],
        "max_abs_err": res["max_abs_err"], "ms": ms128,
        "library_ms": lib128, **bound128,
        **bound_shares(bound128, ms128),
        "live_tflops_per_s": flash_flops(q) / (ms128 * 1e-3) / 1e12,
        "ms_over_library_ms": ms128 / lib128,
    }]
    del q, k, v
    torch.cuda.empty_cache()

    # The wgmma design at head_dim 32 and 16, which no model of the port
    # serves at scale: 8 heads / 4 KV heads at batch 4 x SMALL_D_SEQ,
    # causal, held on two requests with the three faulty plain versions
    # refused (one leaves a 128-key tile out), and timed beside its bound
    # (the MUFU's, one ex2 a live pair), its plain version and SDPA.
    for dm in (32, 16):
        q, k, v = attn_inputs(gen, 4, 8, 4, SMALL_D_SEQ, SMALL_D_SEQ, dm,
                              bf16)
        bn = flash_mod.wgmma_tile(dm).bn
        res, refusals = hold_flash_layer(
            f"flash head_dim-{dm} layer q={list(q.shape)} k={list(k.shape)} "
            "bf16", q, k, v, requests=(0, 3),
            drop_tile=SMALL_D_SEQ * 3 // 4 // bn * bn, tile=bn)
        if res["design"] != "wgmma":
            raise AssertionError(f"{res['case']} ran {res['design']}")
        cases.append(res)
        refused += refusals
        timed = time_flash_layer(q, k, v)
        lib = time_cuda(lambda: library_attention(q, k, v, True),
                        reps=TIMING_REPS)
        flash["shapes"].append({
            "case": f"head_dim-{dm} layer", "q": list(q.shape),
            "k": list(k.shape), "design": res["design"],
            "max_abs_err": res["max_abs_err"], **timed, "library_ms": lib,
            "plain_ms": time_cuda(lambda: ref.flash_attention_ref(q, k, v),
                                  reps=2),
            "ms_over_library_ms": timed["ms"] / lib,
            "mufu_per_s": mufu_per_s(),
        })
        del q, k, v
    torch.cuda.empty_cache()

    shapes = []
    for name, b, s in (
        ("served decode step", SERVE_BATCH, SERVE_MAX_LEN),
        ("DECODE_32K layer", DECODE_32K.global_batch, DECODE_32K.seq_len),
    ):
        q, k, v = attn_inputs(gen, b, h, kv, 1, s, d, bf16)
        res, refusals, entry = hold_decode_step(name, q, k, v, s, DECODE_TILE)
        cases.append(res)
        refused += refusals
        shapes.append(entry)
        if b == DECODE_32K.global_batch:
            ragged = torch.randint(1, s + 1, (b,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            cases.append(check_decode(
                f"decode {name} q={list(q.shape)} k={list(k.shape)} bf16 "
                "ragged [B] lengths", q, k, v, ragged, scaled=True)[0])
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

    # Gemma2-2B's two layers (bf16, head_dim 256: the wgmma design, 64-key
    # tiles). No single PyTorch call computes a softcap: no library time.
    cap = gemma2_2b.CONFIG.attn_logit_softcap
    drop = SERVE_PROMPT * 3 // 4  # a tile every later row of both layers sees
    for name, batch, window in GEMMA2_LAYERS:
        q, k, v = gemma2_inputs(gen, batch)
        res, refusals = hold_flash_layer(
            f"flash Gemma2-2B {name} layer q={list(q.shape)} "
            f"k={list(k.shape)} bf16 window={window} softcap={cap}",
            q, k, v, requests=(0, batch - 1), window=window, softcap=cap,
            drop_tile=drop)
        cases.append(res)
        refused += refusals
        flash["shapes"].append({
            "case": f"Gemma2-2B {name} layer (window {window}, softcap {cap})",
            "q": list(q.shape), "k": list(k.shape), "design": res["design"],
            "max_abs_err": res["max_abs_err"], "library_ms": None,
            **time_flash_layer(q, k, v, window, cap),
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
    if gemma2_run is not None:
        flash["launches_serve_gemma2"] = gemma2_run["launches"]["flash_attention"]
        flash["launches_serve_gemma2_by_design"] = gemma2_run["flash_by_design"]
        decode["launches_serve_gemma2"] = gemma2_run["launches"]["decode_attention"]
        decode["launches_serve_gemma2_per_step"] = gemma2_run["decode_per_step"]
        decode["launches_serve_gemma2_by_design"] = gemma2_run["decode_by_design"]
    return [flash, decode]


def phase_ffma_times(seed: int, checks: dict | None = None) -> dict:
    """The float32 ``ffma`` designs of both attention kernels at the float32
    ``serve_check`` shapes (SERVE_CHECKS): each config's prefill layers
    and its decode step at the last teacher-forced position, held to
    their plain versions at the tables' 2e-5, timed beside their bounds
    (flash: flops at the FFMA peak, TF32 being off; decode: bytes), their
    plain versions and, where no softcap rules it out, SDPA's
    memory-efficient backend in float32. At each flash layer the 2e-5
    limit must refuse three faulty plain versions (``hold_flash_layer``:
    ``kv = h % KV``, the causal diagonal excluded, one ``ffma`` key tile
    left out), each keeping the layer's window and softcap; at each decode
    step (timed with its softcap, ``decode_step_times``) three more:
    ``length - 1``, one ``ffma`` tile of the cache left out and ``kv = h %
    KV``; and the step replayed from a CUDA graph three times in a row must
    equal its eager output (``graph_replays``). ``checks``: the launches
    by design of each ``serve_check`` run, by config name."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    f32 = torch.float32
    rows = {"flash_attention": [], "decode_attention": []}
    refused = []
    for cfg, b, s in SERVE_CHECKS:
        launches = {} if checks is None else {
            "launches_serve_check_float32": checks[cfg.name]["float32"]}
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        cap = cfg.attn_logit_softcap
        depth = s + CHECK_STEPS
        for kind in sorted(set(cfg.block_pattern)):
            window = cfg.sliding_window if kind == "local" else None
            q, k, v = attn_inputs(gen, b, h, kv, s, s, d, f32)
            bn = flash_mod.ffma_tile(d).bn
            res, refusals = hold_flash_layer(
                f"flash ffma {cfg.name} {kind} layer q={list(q.shape)} "
                f"float32", q, k, v, None, window, cap,
                drop_tile=s * 3 // 4 // bn * bn, tile=bn)
            if res["design"] != "ffma":
                raise AssertionError(f"{res['case']} ran {res['design']}")
            refused += refusals
            row = {"config": cfg.name, "layer": kind, "q": list(q.shape),
                   "k": list(k.shape), "window": window, "softcap": cap,
                   "design": res["design"], "max_abs_err": res["max_abs_err"],
                   **time_flash_layer(q, k, v, window, cap),
                   "graph_ms": time_graph(lambda: ops.flash_attention(
                       q, k, v, window=window, softcap=cap), reps=TIMING_REPS),
                   "plain_ms": time_cuda(lambda: ref.flash_attention_ref(
                       q, k, v, window=window, softcap=cap), reps=5),
                   **{key: by_kernel["flash_attention"]
                      for key, by_kernel in launches.items()}}
            if cap is None and window is None:
                kk, vv = repeat_kv(k, h), repeat_kv(v, h)
                row["library_ms"] = time_cuda(
                    lambda: library_attention_f32(q, kk, vv, True),
                    reps=TIMING_REPS)
                del kk, vv
            else:
                row["library_ms"] = None
            rows["flash_attention"].append(row)
            del q, k, v
        # decode at the last step: the global cache (or the only kind) at
        # its full depth, with the config's softcap
        q, k, v = attn_inputs(gen, b, h, kv, 1, depth, d, f32)
        n = torch.tensor(depth, dtype=torch.int32, device="cuda")
        what = (f"decode ffma {cfg.name} q={list(q.shape)} k={list(k.shape)} "
                f"float32")
        res, got = check_decode(what, q, k, v, n, cap)
        tile = decode_mod.tile_slots(f32, d)
        start = depth // 2 // tile * tile
        for text, faulty in (
            ("length - 1", lambda: ref.decode_attention_ref(
                q, k, v, n - 1, softcap=cap)),
            (f"cache slots {start} .. {start + tile - 1} left out (one "
             "ffma tile)", lambda: tile_dropped_plain(
                 q, k, v, n, start, tile, cap)),
            ("kv = h % KV", lambda: head_mod_decode_plain(q, k, v, n, cap)),
        ):
            refused.append(refuse(f"a decode plain version with {text} "
                                  f"({what})", got, faulty(), scaled=False))
        replays = graph_replays(
            lambda: ops.decode_attention(q, k, v, n, softcap=cap), got)
        row = {"config": cfg.name, "q": list(q.shape), "k": list(k.shape),
               "length": depth, "softcap": cap, "design": res["design"],
               "max_abs_err": res["max_abs_err"],
               "graph_replays_equal_to_eager": replays,
               **decode_step_times(q, k, v, depth, cap),
               "plain_ms": time_cuda(lambda: ref.decode_attention_ref(
                   q, k, v, n, softcap=cap), reps=TIMING_REPS),
               **{key: by_kernel["decode_attention"]
                  for key, by_kernel in launches.items()}}
        if cap is None:
            kk, vv = repeat_kv(k, h), repeat_kv(v, h)
            row["library_ms"] = time_graph(
                lambda: library_attention_f32(q, kk, vv, False),
                reps=TIMING_REPS)
            del kk, vv
        else:
            row["library_ms"] = None
        rows["decode_attention"].append(row)
        del q, k, v, got
    torch.cuda.empty_cache()
    out = {
        **rows,
        "refused": refused,
        "library_call": "scaled_dot_product_attention, efficient backend, "
                        "float32, TF32 off, k/v repeated to H heads",
        "timing": "flash: eager, CUDA events (graph_ms: replayed from a "
                  "CUDA graph); decode and its library call: replayed from a "
                  "CUDA graph, kernel_us by torch.profiler",
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
    }
    emit("ffma_times", **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3, help="timed steps")
    ap.add_argument("--seq", type=int, default=512, help="tokens per agent")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra rollout batch, one extra "
                         "training step and one extra decode step of "
                         "Qwen2-0.5B and of Mixtral-8x7B with torch.profiler")
    # one rank process of train_tp / serve_tp / train_pod / serve_2d,
    # started by run_tp_ranks
    ap.add_argument("--tp-rank", nargs=3, metavar=("PHASE", "RANK", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    if args.tp_rank is not None:
        phase, rank, work = args.tp_rank
        tp_rank_main(phase, int(rank), work, args.seed)
        return 0

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    checked = phase_kernel_check(args.seed)
    phase_attention_check(args.seed)
    phase_small_reference(args.seed)
    phase_rollout(args.profile)
    params, plan, launches, leaves = phase_train(
        args.seed, args.steps, args.seq, args.profile
    )
    kernels = [phase_kernels(params, plan, launches, leaves, args.seed)]
    del params, plan
    torch.cuda.empty_cache()
    launched = phase_train_launch(args.seed)
    no_g = launched["no_g_at_embedding_leaf"]
    no_g_held = launched["no_g_every_leaf"]
    kernels[0]["launches_train_launch"] = launched["kernel_launches"]
    kernels[0]["launches_train_launch_per_step"] = launched["launches_per_step"]
    kernels[0]["no_g"] = {
        **{k: no_g[k] for k in ("form", "shape", "dtype", "neighbours",
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_call")},
        "max_abs_err": max(
            [no_g_held["max_abs_err"]]
            + [c["max_abs_err"] for c in checked if c.get("no_g")]),
        "max_abs_err_case_table": max(
            c["max_abs_err"] for c in checked if c.get("no_g")),
        "max_abs_err_every_leaf": no_g_held["max_abs_err"],
        "max_abs_err_embedding_leaf": no_g["max_abs_err"],
        "fewest_refused_err_over_limit_every_leaf":
            no_g_held["fewest_refused_err_over_limit"],
        "launches_train_launch": launched["kernel_launches"],
    }
    flat = per_agent_flat_combine(args.seed, launched["mixing_matrix"])
    mesh = phase_mesh_init()
    trained_mesh = phase_train_mesh(args.seed, mesh)
    served_mesh = phase_serve_mesh(args.seed, mesh)
    torch.distributed.destroy_process_group()
    trained_tp = phase_train_tp(args.seed)
    serve_refs = mixtral_serve_references(args.seed)
    served_tp = phase_serve_tp(args.seed, serve_refs)
    tp_local = tp_local_attention_kernels(args.seed)
    trained_pod = phase_train_pod(args.seed)
    served_2d = phase_serve_2d(args.seed, serve_refs)
    del serve_refs
    pod_local = pod_local_attention_kernels(args.seed)
    pod_combine = pod_local_combine(args.seed, max(
        trained_pod["local_shapes_rank0_all"].values(), key=math.prod))
    kernels[0]["launches_train_tp_by_rank"] = [
        r["mixing_sgd_combine"] for r in trained_tp["launches_by_rank"]]
    kernels[0]["launches_train_pod_by_rank"] = [
        r["mixing_sgd_combine"] for r in trained_pod["launches_by_rank"]]
    kernels[0]["pod_local_leaf"] = {
        k: pod_combine[k] for k in (
            "leaf_shape", "form", "n", "neighbours", "dtype", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_call",
            "max_abs_err", "dropped_row_refused_err_over_limit")}
    kernels[0]["per_agent_flat"] = {
        **{k: flat[k] for k in ("form", "n", "neighbours", "dtype", "ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_call", "max_abs_err",
                                "dropped_row_refused_err_over_limit")},
        "launches_train_mesh": trained_mesh["flat_gossip_launches"],
    }
    kernels[0]["launches_train_mesh"] = trained_mesh["flat_gossip_launches"]
    kernels[0]["max_abs_err_per_agent_flat"] = flat["max_abs_err"]
    elastic = phase_elastic(args.seed)
    kernels[0]["launches_elastic"] = elastic["kernel_launches"]
    kernels[0]["max_abs_err_elastic"] = elastic["max_abs_err"]
    kernels[0]["elastic_embedding_leaf_m7"] = [
        s["embedding_leaf_combine"] for s in elastic["segments"]
        if "embedding_leaf_combine" in s]
    designed = phase_design(args.seed, args.seq)
    kernels[0]["launches_gate"] = designed["gate"]
    kernels[0]["launches_gate_per_step"] = designed["gate_per_step"]
    kernels[0]["launches_full_width"] = designed["full_width"]
    kernels[0]["max_abs_err_main_path_shapes"] = kernels[0]["max_abs_err"]
    kernels[0]["max_abs_err_gate_plans"] = designed["gate_max_abs_err"]
    kernels[0]["max_abs_err_full_width"] = designed["full_width_max_abs_err"]
    kernels[0]["max_abs_err"] = max(
        kernels[0]["max_abs_err"], designed["gate_max_abs_err"],
        designed["full_width_max_abs_err"], kernels[0]["no_g"]["max_abs_err"],
        elastic["max_abs_err"], flat["max_abs_err"],
        pod_combine["max_abs_err"])
    checks = {cfg.name: phase_serve_check(args.seed, cfg, b, s)
              for cfg, b, s in SERVE_CHECKS}
    serve_run = phase_serve(args.seed, args.profile)
    gemma2_run = phase_serve_gemma2(args.seed)
    mixtral_run = phase_serve_mixtral(args.seed, args.profile)
    served = {"serve_jamba": phase_serve_jamba(args.seed),
              "serve_xlstm": phase_serve_xlstm(args.seed),
              "serve_llava": phase_serve_llava(args.seed),
              "serve_musicgen": phase_serve_musicgen(args.seed)}
    kernels += phase_attention_kernels(args.seed, serve_run, gemma2_run)
    for kernel, designs in ((kernels[1], "flash_by_design"),
                            (kernels[2], "decode_by_design")):
        kernel["launches_serve_mesh"] = served_mesh["launches"][kernel["name"]]
        kernel["launches_serve_mesh_by_design"] = served_mesh[designs]
    for key, run in {"serve_mixtral": mixtral_run, **served}.items():
        add_served(kernels[1], kernels[2], key, run)
    for kernel in kernels[1:]:
        kernel["launches_serve_tp_by_rank"] = [
            r[kernel["name"]] for r in served_tp["launches_by_rank"]]
        kernel["tp_local_shapes"] = tp_local[kernel["name"]]
        kernel["launches_serve_2d_by_rank"] = [
            r[kernel["name"]] for r in served_2d["launches_by_rank"]]
        kernel["pod_local_shapes"] = pod_local[kernel["name"]]
    ffma = phase_ffma_times(args.seed, checks)
    kernels[1]["ffma"] = ffma["flash_attention"]
    kernels[2]["ffma"] = ffma["decode_attention"]
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
