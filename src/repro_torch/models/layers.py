"""Shared neural-net layers (plain functions on dicts of tensors).

Counterpart of the JAX package's ``models/layers.py``: norms,
projections, RoPE, SwiGLU. Initializers take an explicit
``torch.Generator`` that lives on the target device; ``param_dtype``
controls storage, ``compute_dtype`` the activation math. ``lead`` is an
optional tuple of leading stack dimensions (the group axis G), so a
stacked leaf is drawn in one call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharding_hints as sh

_SQRT2 = math.sqrt(2.0)
# Φ(−2) and Φ(2): the truncated normal is drawn by inverse CDF on (−2, 2).
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))


# Largest float32 draw made in one piece: 4 GiB. A larger leaf (Mixtral's
# stacked expert weights, [G, 8, 4096, 14336]) is drawn slice by slice
# along its leading axis into its output, so its float32 temporaries stay
# within this size.
SINGLE_DRAW_MAX_BYTES = 4 * 2**30


def _truncated_normal_(u: torch.Tensor, scale) -> torch.Tensor:
    """Uniform(Φ(−2), Φ(2)) draws in ``u`` → ``scale`` × the truncated
    normal, in place (inverse CDF)."""
    u.mul_(2.0).sub_(1.0).erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
    # 1/sqrt(fan_in)-style scaling is applied by callers via `scale`.
    return u.mul_(scale)


def truncated_normal_init(generator, shape, scale, dtype, device):
    """``scale`` × a standard normal truncated to (−2, 2), drawn in
    float32 from ``generator`` and cast to ``dtype``. On the ``meta``
    device only the shape is made (for counting parameters). A leaf of
    more than SINGLE_DRAW_MAX_BYTES in float32 is drawn in slices of its
    leading axis, in order, each cast into the preallocated output."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    shape = tuple(shape)
    numel = math.prod(shape)
    if numel * 4 <= SINGLE_DRAW_MAX_BYTES:
        u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
            _CDF_LO, _CDF_HI, generator=generator
        )
        return _truncated_normal_(u, scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    per_row = numel // shape[0]
    rows = max(1, SINGLE_DRAW_MAX_BYTES // (4 * per_row))
    for i in range(0, shape[0], rows):
        part = out[i:i + rows]
        u = torch.empty(part.shape, dtype=torch.float32, device=device)
        u.uniform_(_CDF_LO, _CDF_HI, generator=generator)
        part.copy_(_truncated_normal_(u, scale))
        del u  # freed before the next slice is drawn, not after
    return out


def dense_init(generator, d_in, d_out, dtype, device, lead=()) -> dict:
    w = truncated_normal_init(
        generator, (*lead, d_in, d_out), d_in**-0.5, dtype, device
    )
    return {"kernel": w}


def dense_init_bias(generator, d_in, d_out, dtype, device, lead=()) -> dict:
    p = dense_init(generator, d_in, d_out, dtype, device, lead)
    p["bias"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def dense_apply(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = x.to(compute_dtype) @ params["kernel"].to(compute_dtype)
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def row_split_apply(params: dict, x: torch.Tensor, compute_dtype,
                    partial: bool) -> torch.Tensor:
    """``dense_apply`` of a layer whose rows may be split over the TP
    ranks: where ``partial``, each rank's product is summed over the ranks
    (``reduce_from_tp``) and the bias added once, after the sum."""
    y = x.to(compute_dtype) @ params["kernel"].to(compute_dtype)
    if partial:
        y = sh.reduce_from_tp(y)
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def embed_init(generator, vocab, d_model, dtype, device) -> dict:
    return {
        "table": truncated_normal_init(
            generator, (vocab, d_model), d_model**-0.5, dtype, device
        )
    }


def embed_apply(params: dict, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[ids.to(torch.int64)]


def unembed_apply(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Project to vocab logits with the (possibly tied) embedding table."""
    return x.to(compute_dtype) @ params["table"].to(compute_dtype).T


def rmsnorm_init(d, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm_apply(
    params: dict, x: torch.Tensor, eps: float, compute_dtype
) -> torch.Tensor:
    # Normalize in fp32 for stability, multiply in compute dtype.
    x32 = x.to(torch.float32)
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(compute_dtype) * params["scale"].to(compute_dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap·tanh(x/cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    return 1.0 / (theta**exponents)  # [head_dim/2]


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float
) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Split-half
    form: the first and second halves of head_dim are the rotated pair."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # [..,S,hd/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(generator, d_model, d_ff, dtype, device, lead=()) -> dict:
    return {
        "gate": dense_init(generator, d_model, d_ff, dtype, device, lead),
        "up": dense_init(generator, d_model, d_ff, dtype, device, lead),
        "down": dense_init(generator, d_ff, d_model, dtype, device, lead),
    }


def mlp_apply(params: dict, x: torch.Tensor, compute_dtype,
              d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU. Under tensor parallelism, where the leaves' d_ff is less
    than the whole ``d_ff``, ``gate``/``up`` are column-split and ``down``
    row-split: the rank's partial sum, summed by ``reduce_from_tp``."""
    partial = d_ff is not None and sh.local_range(
        params["down"]["kernel"].shape[-2], d_ff)[2]
    if partial:
        x = sh.copy_to_tp(x)
    gate = F.silu(dense_apply(params["gate"], x, compute_dtype))
    up = dense_apply(params["up"], x, compute_dtype)
    return row_split_apply(params["down"], gate * up, compute_dtype, partial)
