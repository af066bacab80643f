"""Roofline terms of a cell from the analytic model and the counted
collectives.

Counterpart of the JAX package's ``roofline/analysis.py``. Three terms
per (arch × shape × mesh), in seconds:

    compute    = FLOPs_global              / (chips × peaks.flops)
    memory     = HBM_bytes_global          / (chips × peaks.hbm_bytes_per_s)
    collective = collective_bytes_per_chip / peaks.link_bytes_per_s

FLOPs and HBM bytes come from the analytic cell model
(``roofline.analytic``), as the reference's do. Collective bytes per chip
are the larger of the analytic model's and the bytes the port counted on
the calling rank (``launch/mesh.collective_stats``: every collective of
the port goes through ``launch/mesh.py``, which adds the bytes of each
call's operand under the reference's five kinds).

Two differences from the reference:

* the peaks are an input (``Peaks``), kept on the report; ``H100`` holds
  the card's;
* ``report`` takes the counted ``CollectiveStats`` in place of HLO text.
  The reference's HLO parsers (``parse_collectives``,
  ``parse_collectives_nested``, ``_split_computations``, ``_trip_count``,
  ``_shape_bytes``) have no counterpart: the port produces no HLO, and its
  count is exact per call because every layer and every microbatch runs
  as Python — there is no loop body counted once, so no trip count.
"""

from __future__ import annotations

import dataclasses

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Peak rates of one chip of a platform: ``flops`` a second of the
    dtype the model runs in, HBM bytes a second, and bytes a second per
    direction on the slowest link every mesh axis crosses."""
    flops: float
    hbm_bytes_per_s: float
    link_bytes_per_s: float


# One H100 SXM5 of a DGX H100 / HGX H100 platform, datasheet peaks (not
# measured on the card):
# * 989e12 — dense bf16 on the tensor cores (NVIDIA H100 datasheet,
#   "BF16 Tensor Core 1,979 teraFLOPS" with sparsity, half without);
# * 3.35e12 — HBM3 bandwidth (the datasheet's 3.35 TB/s);
# * 50e9 — one 400 Gb/s NDR InfiniBand NIC (ConnectX-7) a GPU, per
#   direction. Ranks are row-major, so ``model``'s 16 consecutive ranks
#   span two 8-GPU nodes and ``data`` strides across 16: every axis of the
#   production mesh crosses this link. Inside a node NVLink 4 gives 450e9
#   bytes a second per direction (900 GB/s both ways).
H100 = Peaks(flops=989e12, hbm_bytes_per_s=3.35e12, link_bytes_per_s=50e9)
# The same datasheet's float32 peak without the tensor cores (TF32 is off
# on every path of the port): the bound of the float32 kernels.
H100_FP32_FLOPS = 67e12


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclasses.dataclass
class RooflineReport:
    """The reference's report, with its field names: ``hlo_flops_global``
    and ``hlo_bytes_global`` hold the analytic model's FLOPs and HBM bytes
    (the reference's hold the same), and ``peaks`` the rates the times
    divide by."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_global: float
    hlo_bytes_global: float
    collective_bytes_per_chip: float
    collective_breakdown: dict
    model_flops_global: float
    compute_s: float
    memory_s: float
    collective_s: float
    peaks: Peaks

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        if self.hlo_flops_global <= 0:
            return float("nan")
        return self.model_flops_global / self.hlo_flops_global

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak compute achieved when running at the modeled
        bound: (model FLOPs / chips / peak) / bound-time."""
        if self.bound_s <= 0:
            return float("nan")
        ideal = self.model_flops_global / (self.chips * self.peaks.flops)
        return ideal / self.bound_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["bound_s"] = self.bound_s
        d["useful_flops_fraction"] = self.useful_flops_fraction
        d["roofline_fraction"] = self.roofline_fraction
        return d


def model_flops(cfg, shape, num_agents: int = 1) -> float:
    """MODEL_FLOPS: 6·N·D for training (N = active params), 2·N·D for
    forward-only shapes, per the standard rule; D = total tokens."""
    from repro_torch.models import model as M

    n_total = M.parameter_count(cfg)
    # Active params for MoE: replace expert FFN params with top_k experts.
    n_active = n_total
    if cfg.num_experts > 0:
        moe_layers = sum(
            1 for k in cfg.block_pattern if k.endswith("_moe")
        ) * cfg.num_groups
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_active = (
            n_total
            - moe_layers * cfg.num_experts * per_expert
            + moe_layers * cfg.num_experts_per_token * per_expert
        )
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence.
    return 2.0 * n_active * shape.global_batch


def analytic_hlo_flops(cfg, shape, remat: bool) -> float:
    """Matmul-only estimate incl. attention score/value matmuls and MoE
    capacity compute; training multiplies by 3 (fwd + 2×bwd) and adds one
    extra forward when full remat is on. (The reference's name: its
    fallback when XLA reports no FLOPs.)
    """
    s = shape.seq_len
    b = shape.global_batch
    hd = cfg.resolved_head_dim
    flops_tok = 0.0  # per token, forward, ×2 for MAC
    attn_extra = 0.0
    for kind in cfg.block_pattern:
        is_attn = kind in ("attn", "attn_moe", "swa", "swa_moe", "local", "global")
        if is_attn:
            qkv = cfg.d_model * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
            out = cfg.num_heads * hd * cfg.d_model
            flops_tok += qkv + out
            ctx = s
            if kind in ("swa", "swa_moe", "local") and cfg.sliding_window:
                ctx = min(s, cfg.sliding_window)
            # causal: average context s/2 for full, ctx for windowed
            avg_ctx = ctx / 2 if ctx == s else ctx
            attn_extra += 2 * cfg.num_heads * hd * avg_ctx
        elif kind.startswith("mamba"):
            di = cfg.ssm_expand * cfg.d_model
            flops_tok += cfg.d_model * 2 * di + di * cfg.d_model
            flops_tok += di * (2 * cfg.ssm_state_dim + 1)
            attn_extra += 2 * di * cfg.ssm_state_dim  # scan update+readout
        elif kind == "mlstm":
            di = 2 * cfg.d_model
            flops_tok += cfg.d_model * 2 * di + di * cfg.d_model
            flops_tok += 3 * di * (di // max(cfg.mlstm_heads, 1))
            attn_extra += 2 * (di // max(cfg.mlstm_heads, 1)) * (s / 2) * cfg.mlstm_heads
        elif kind == "slstm":
            flops_tok += 8 * cfg.d_model * cfg.d_model
        if kind.endswith("_moe"):
            cap_factor = cfg.capacity_factor * cfg.num_experts_per_token
            flops_tok += 3 * cfg.d_model * cfg.d_ff * cap_factor
        elif kind in ("attn", "swa", "local", "global") or kind == "mamba":
            if cfg.d_ff > 0:
                flops_tok += 3 * cfg.d_model * cfg.d_ff
    flops_tok *= cfg.num_groups
    attn_extra *= cfg.num_groups
    flops_tok += cfg.vocab_size * cfg.d_model  # lm head
    total_fwd = 2.0 * (flops_tok + attn_extra) * b * s
    if shape.kind == "train":
        mult = 3.0 + (1.0 if remat else 0.0)
        return total_fwd * mult
    if shape.kind == "prefill":
        return total_fwd
    # decode: context-length attention reads, single token
    return 2.0 * flops_tok * b + 2.0 * attn_extra * b / max(s, 1) * 2


def report(
    *,
    arch: str,
    shape,
    cfg,
    mesh_name: str,
    chips: int,
    collectives: CollectiveStats,
    peaks: Peaks = H100,
    num_agents: int = 1,
    remat: bool = True,
    tcfg=None,
    mesh_shape: dict | None = None,
    gossip_directed_edges: int = 0,
) -> RooflineReport:
    """Primary numbers come from the analytic cell model
    (``roofline.analytic``). Collective bytes take the max of the
    analytic model and ``collectives``, the bytes counted on one rank."""
    from repro_torch.roofline import analytic

    coll = collectives
    mesh_shape = mesh_shape or {"total": chips}

    if shape.kind == "train":
        from repro_torch.configs.base import TrainConfig

        cell = analytic.train_model(
            cfg, shape, tcfg or TrainConfig(), mesh_shape, num_agents,
            gossip_directed_edges,
        )
    else:
        cell = analytic.serve_model(cfg, shape, mesh_shape)

    flops_global = cell.flops_global
    bytes_global = cell.hbm_bytes_global
    coll_per_chip = max(cell.collective_bytes_per_chip, float(coll.total_bytes))
    breakdown = dict(coll.bytes_by_kind)
    breakdown["analytic"] = dict(cell.collective_detail)
    return RooflineReport(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops_global=flops_global,
        hlo_bytes_global=bytes_global,
        collective_bytes_per_chip=coll_per_chip,
        collective_breakdown=breakdown,
        model_flops_global=model_flops(cfg, shape, num_agents),
        compute_s=flops_global / (chips * peaks.flops),
        memory_s=bytes_global / (chips * peaks.hbm_bytes_per_s),
        collective_s=coll_per_chip / peaks.link_bytes_per_s,
        peaks=peaks,
    )
