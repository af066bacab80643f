"""Analytic FLOPs / HBM-bytes / collective-bytes models per cell.

Counterpart of the JAX package's ``roofline/analytic.py``, returning
bitwise what it returns. These closed-form models — functions of the
architecture, shape, layout and mesh — are the primary roofline inputs;
the collective bytes the port counts at every call
(``launch/mesh.collective_stats``, read by ``launch/dryrun.py``) serve as
a cross-check.

Conventions: "global" quantities sum over all chips; per-chip = global /
chips. All byte counts are logical payload bytes (collective algorithm
factors like ring 2(n−1)/n are folded into an EFFICIENCY constant).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig

BF16 = 2
F32 = 4

# HBM passes per activation boundary in a remat'd train step:
# fwd write + bwd read + recompute write/read + grad pass ≈ 6.
ACT_PASSES_TRAIN = 6.0
ACT_PASSES_FWD = 2.0
ALLREDUCE_FACTOR = 2.0  # ring all-reduce moves ~2× payload per chip


def _attn_kinds(cfg: ModelConfig):
    return [
        k for k in cfg.block_pattern
        if k in ("attn", "attn_moe", "swa", "swa_moe", "local", "global")
    ]


def _layer_param_bytes(cfg: ModelConfig) -> float:
    """Parameter bytes of one repeating group / len(pattern) (avg layer)."""
    from repro_torch.models import model as M

    return M.parameter_count(cfg) * BF16 / cfg.num_layers


@dataclasses.dataclass(frozen=True)
class CellModel:
    flops_global: float
    hbm_bytes_global: float
    collective_bytes_per_chip: float
    collective_detail: dict


def _flops_forward_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """Matmul MACs×2 per token, full depth, incl. attention quadratic."""
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind in cfg.block_pattern:
        is_attn = kind in ("attn", "attn_moe", "swa", "swa_moe", "local",
                           "global")
        if is_attn:
            total += 2 * cfg.d_model * hd * (
                cfg.num_heads + 2 * cfg.num_kv_heads
            )
            total += 2 * cfg.num_heads * hd * cfg.d_model
            ctx = seq_len
            if kind in ("swa", "swa_moe", "local") and cfg.sliding_window:
                ctx = min(seq_len, cfg.sliding_window)
            avg_ctx = ctx / 2 if ctx == seq_len else ctx
            total += 2 * 2 * cfg.num_heads * hd * avg_ctx  # QKᵀ and PV
        elif kind.startswith("mamba"):
            di = cfg.ssm_expand * cfg.d_model
            total += 2 * (cfg.d_model * 2 * di + di * cfg.d_model)
            total += 2 * di * (2 * cfg.ssm_state_dim + 1)
            total += 8 * di * cfg.ssm_state_dim  # scan combine + readout
        elif kind == "mlstm":
            di = 2 * cfg.d_model
            hd_m = di // max(cfg.mlstm_heads, 1)
            total += 2 * (cfg.d_model * 2 * di + di * cfg.d_model)
            total += 2 * 3 * di * hd_m
            total += 2 * 2 * hd_m * (seq_len / 2) * cfg.mlstm_heads
        elif kind == "slstm":
            total += 2 * 8 * cfg.d_model * cfg.d_model
        if kind.endswith("_moe"):
            total += (
                2 * 3 * cfg.d_model * cfg.d_ff
                * cfg.num_experts_per_token * cfg.capacity_factor
            )
        elif kind in ("attn", "swa", "local", "global", "mamba") and cfg.d_ff:
            total += 2 * 3 * cfg.d_model * cfg.d_ff
    total *= cfg.num_groups
    total += 2 * cfg.vocab_size * cfg.d_model  # LM head
    return total


def train_model(
    cfg: ModelConfig,
    shape: ShapeConfig,
    tcfg: TrainConfig,
    mesh_shape: dict,
    num_agents: int,
    gossip_directed_edges: int,
) -> CellModel:
    from repro_torch.models import model as M

    chips = 1
    for v in mesh_shape.values():
        chips *= v
    tokens = shape.global_batch * shape.seq_len
    n_params = M.parameter_count(cfg)
    k_mb = max(tcfg.microbatch, 1)
    tp = mesh_shape.get("model", 1)
    fsdp = mesh_shape.get("data", 1) if tcfg.agent_layout == "pod" else 1
    dp_inner = 1
    if tcfg.agent_layout == "data_dp":
        # "model" axis repurposed as intra-agent DP: no TP collectives;
        # instead one fp32 gradient all-reduce per step over that axis.
        dp_inner, tp = tp, 1

    # FLOPs: fwd + 2×bwd + remat refwd.
    remat_mult = 4.0 if tcfg.remat != "none" else 3.0
    flops = _flops_forward_per_token(cfg, shape.seq_len) * tokens * remat_mult

    # HBM bytes (global).
    param_passes = (3.0 if tcfg.remat != "none" else 2.0) * k_mb + 6.0
    params_bytes = num_agents * n_params * BF16 * param_passes
    acts_bytes = (
        tokens * cfg.d_model * BF16 * cfg.num_layers * ACT_PASSES_TRAIN
    )
    hbm = params_bytes + acts_bytes

    # Collectives (per chip). Payloads are the chip-LOCAL activation
    # shard: tokens / (agents × microbatches × fsdp).
    detail = {}
    tokens_local_mb = tokens / max(num_agents, 1) / k_mb / fsdp
    # TP activation all-reduces: ~2 fwd + 2 bwd per layer per microbatch.
    if tp > 1:
        detail["tp_allreduce"] = (
            4.0 * cfg.num_layers * k_mb
            * tokens_local_mb * cfg.d_model * BF16
            * ALLREDUCE_FACTOR * (tp - 1) / tp
        )
    # FSDP: all-gather params fwd+bwd(+remat) and reduce-scatter grads,
    # per microbatch.
    if fsdp > 1:
        passes = (3.0 if tcfg.remat != "none" else 2.0) + 1.0
        detail["fsdp"] = (
            passes * k_mb * (n_params * BF16 / tp) * (fsdp - 1) / fsdp
        )
    # Intra-agent DP (data_dp): per-step bf16 gradient all-reduce
    # (fp32 local accumulation, bf16 on the wire).
    if dp_inner > 1:
        detail["dp_grad_allreduce"] = (
            n_params * BF16 * ALLREDUCE_FACTOR * (dp_inner - 1) / dp_inner
        )
    # Gossip: each directed activated edge ships the agent's param shard
    # (data_dp ravels the replicated tree and slices it over "model").
    if num_agents > 1 and gossip_directed_edges:
        kappa_shard = n_params * BF16 / (max(tp, dp_inner) * fsdp)
        per_agent_edges = gossip_directed_edges / num_agents
        detail["gossip"] = per_agent_edges * kappa_shard
        if dp_inner > 1:
            # write-back all-gather of the mixed flat tree
            detail["gossip"] += n_params * BF16 * (dp_inner - 1) / dp_inner
    coll = sum(detail.values())
    return CellModel(flops, hbm, coll, detail)


def serve_model(
    cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict
) -> CellModel:
    from repro_torch.models import model as M

    chips = 1
    for v in mesh_shape.values():
        chips *= v
    n_params = M.parameter_count(cfg)
    tp = mesh_shape.get("model", 1)
    dp = chips // tp
    hd = cfg.resolved_head_dim
    attn_layers = len(_attn_kinds(cfg)) * cfg.num_groups

    def cache_tokens(seq):
        """KV slots read per attention layer (window-limited)."""
        full = seq
        tot = 0.0
        for k in _attn_kinds(cfg):
            ctx = full
            if k in ("swa", "swa_moe", "local") and cfg.sliding_window:
                ctx = min(full, cfg.sliding_window)
            tot += ctx
        return tot * cfg.num_groups

    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        flops = _flops_forward_per_token(cfg, shape.seq_len) * tokens
        hbm = (
            n_params * BF16 * max(dp, 1)
            + tokens * cfg.d_model * BF16 * cfg.num_layers * ACT_PASSES_FWD
            + shape.global_batch * cache_tokens(shape.seq_len)
            * 2 * cfg.num_kv_heads * hd * BF16  # cache writes
        )
        detail = {}
        if tp > 1:  # seq-parallel prefill boundaries: ~1x payload
            detail["tp_allreduce"] = (
                4.0 * cfg.num_layers
                * (tokens / max(dp, 1)) * cfg.d_model * BF16
                * 1.0 * (tp - 1) / tp
            )
        return CellModel(flops, hbm, sum(detail.values()), detail)

    # decode: one token per sequence.
    b = shape.global_batch
    # Active params (MoE: top-k experts per token; small b may not touch all)
    n_active = n_params
    if cfg.num_experts > 0:
        moe_layers = sum(
            1 for k in cfg.block_pattern if k.endswith("_moe")
        ) * cfg.num_groups
        per_expert = 3 * cfg.d_model * cfg.d_ff
        experts_hit = min(
            cfg.num_experts, b * cfg.num_experts_per_token
        )
        n_active = (
            n_params
            - moe_layers * cfg.num_experts * per_expert
            + moe_layers * experts_hit * per_expert
        )
    flops = 2.0 * (n_active / max(1, 1)) * b  # matmul flops ≈ 2·N per token
    cache_bytes = (
        b * cache_tokens(shape.seq_len) * 2 * cfg.num_kv_heads * hd * BF16
    )
    # Recurrent state reads: mamba/mlstm states per layer.
    state_bytes = 0.0
    for kind in cfg.block_pattern:
        if kind.startswith("mamba"):
            di = cfg.ssm_expand * cfg.d_model
            state_bytes += b * di * cfg.ssm_state_dim * F32
        elif kind == "mlstm":
            di = 2 * cfg.d_model
            hd_m = di // max(cfg.mlstm_heads, 1)
            state_bytes += b * cfg.mlstm_heads * hd_m * hd_m * F32
    state_bytes *= cfg.num_groups
    hbm = n_active * BF16 + cache_bytes + 2 * state_bytes
    flops += 2 * cache_bytes / BF16  # attention reads ≈ 2 FLOPs per elem
    detail = {}
    if tp > 1:
        detail["tp_allreduce"] = (
            4.0 * cfg.num_layers * b / max(dp, 1) * cfg.d_model * BF16
            * ALLREDUCE_FACTOR * (tp - 1) / tp
        )
    return CellModel(flops, hbm, sum(detail.values()), detail)
