"""GQA attention: full / sliding-window / local-global, training form.

Counterpart of the JAX package's ``models/attention.py``, written as
plain torch ops exactly as the reference is plain jnp (float32 logits,
the same mask constant, probabilities cast to the compute dtype before
``@ v``) — not a fused library attention, whose numerics differ. The
chunked long-sequence path, the decode caches and prefill belong to the
serving slice and are not here yet.

Layout: activations ``[B, S, H, Dh]``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers

NEG_INF = -2.0e38

# Sequences at or above this length need the chunked (flash-style) path.
CHUNKED_ATTN_THRESHOLD = 8192


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    window: int | None         # None = full causal
    rope_theta: float
    softcap: float | None      # attention-logit softcap (gemma2)
    qkv_bias: bool


def init(generator, spec: AttnSpec, dtype, device, lead=()) -> dict:
    mk = layers.dense_init_bias if spec.qkv_bias else layers.dense_init
    q_out = spec.num_heads * spec.head_dim
    kv_out = spec.num_kv_heads * spec.head_dim
    return {
        "wq": mk(generator, spec.d_model, q_out, dtype, device, lead),
        "wk": mk(generator, spec.d_model, kv_out, dtype, device, lead),
        "wv": mk(generator, spec.d_model, kv_out, dtype, device, lead),
        "wo": layers.dense_init(
            generator, q_out, spec.d_model, dtype, device, lead
        ),
    }


def _project_qkv(params, x, spec: AttnSpec, positions, compute_dtype):
    b, s, _ = x.shape
    q = layers.dense_apply(params["wq"], x, compute_dtype).reshape(
        b, s, spec.num_heads, spec.head_dim
    )
    k = layers.dense_apply(params["wk"], x, compute_dtype).reshape(
        b, s, spec.num_kv_heads, spec.head_dim
    )
    v = layers.dense_apply(params["wv"], x, compute_dtype).reshape(
        b, s, spec.num_kv_heads, spec.head_dim
    )
    if spec.rope_theta > 0:  # theta == 0 ⇒ NoPE (e.g. Jamba attention)
        q = layers.apply_rope(q, positions, spec.rope_theta)
        k = layers.apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, spec: AttnSpec, compute_dtype):
    """Grouped scaled-dot-product attention. q:[B,Sq,H,D] k/v:[B,Sk,Hkv,D];
    mask:[B,Sq,Sk] boolean, True = attend."""
    groups = spec.num_heads // spec.num_kv_heads
    b, sq, h, d = q.shape
    qg = q.reshape(b, sq, spec.num_kv_heads, groups, d)
    logits = torch.einsum(
        "bqkgd,bskd->bkgqs", qg.to(torch.float32), k.to(torch.float32)
    ) * (d**-0.5)
    logits = layers.softcap(logits, spec.softcap)
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(compute_dtype), v)
    return out.reshape(b, sq, h, d)


def causal_mask(sq: int, sk: int, window: int | None, device=None) -> torch.Tensor:
    """[sq, sk] boolean; True = attend. Optionally sliding-window limited."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def apply_train(
    params, x, spec: AttnSpec, compute_dtype, window_override=None
) -> torch.Tensor:
    """Full-sequence training attention. x: [B, S, D], S < 8192."""
    b, s, _ = x.shape
    if s >= CHUNKED_ATTN_THRESHOLD:
        raise NotImplementedError(
            f"sequence length {s} >= {CHUNKED_ATTN_THRESHOLD} needs the "
            "chunked attention path, which arrives with the serving slice "
            "(ROADMAP queue A, serving)"
        )
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, spec, positions, compute_dtype)
    window = spec.window if window_override is None else window_override
    mask = causal_mask(s, s, window, x.device).expand(b, s, s)
    out = _sdpa(q, k, v, mask, spec, compute_dtype)
    return layers.dense_apply(
        params["wo"], out.reshape(b, s, -1), compute_dtype
    )
