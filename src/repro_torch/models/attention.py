"""GQA attention: full / sliding-window / local-global, train + serve.

Counterpart of the JAX package's ``models/attention.py``. The training
form is written as plain torch ops exactly as the reference is plain jnp
(float32 logits, the same mask constant, probabilities cast to the
compute dtype before ``@ v``), and so is the chunked long-sequence form
``_sdpa_chunked`` — not a fused library attention, whose numerics differ.
The serving path is where the port departs: ``prefill_cache`` runs its
attention through ``kernels.ops.flash_attention`` and ``apply_decode``
through ``kernels.ops.decode_attention`` (the hand-written CUDA kernels on
the card, their plain versions on the CPU), where the reference computes
both in jnp.

Layout: activations ``[B, S, H, Dh]``. Cache (per layer): ``{"k": [B,
S_cache, H_kv, Dh], "v": same, "pos": int32 [] next write position}``.
Sliding-window layers allocate ``S_cache = min(max_len, window)`` and
write round-robin; global layers allocate the full context. The kernels
take these as transposed ``[B, H, S, Dh]`` views: nothing is copied.

Caches are written **in place** (``index_copy_`` at a slot held on the
device) and the same dict is returned, where the reference returns new
arrays; ``pos`` stays an int32 device tensor, so a decode step reads
nothing back to the host.

Tensor parallelism (``sharding_hints.tp()``): the head counts come from
the local weights, not from the spec. ``head_plan`` reads ``wo``'s local
rows — the block of ``H·Dh`` this rank's partial sum covers — and picks
the query heads that cover them (whole GQA groups where the rows would
leave the local group uneven) and their KV heads. ``wq``/``wk``/``wv``
are used as they lie when their split matches, else gathered whole and
sliced (``sharding_hints.take``). The kernels get the local heads; the
cache holds the rank's KV heads; ``wo``'s partial sums go through
``reduce_from_tp``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models import sharding_hints as sh

NEG_INF = -2.0e38

# Training sequences at or above this length use the chunked
# (flash-style) path: the monolithic [Sq, Sk] logits would not fit.
CHUNKED_ATTN_THRESHOLD = 8192
CHUNK_Q = 1024
CHUNK_K = 1024


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


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """This rank's part of one attention layer: query heads ``[q0, q1)``,
    KV heads ``[k0, k1)``, the rows ``[lo, hi)`` of ``wo`` (of the
    flattened ``H·Dh``) it holds, and whether its output is a partial
    sum over the TP ranks."""
    q0: int
    q1: int
    k0: int
    k1: int
    lo: int
    hi: int
    partial: bool
    head_dim: int


def head_plan(params, spec: AttnSpec) -> HeadPlan:
    """The heads this rank computes (module docstring); every head on one
    card or where ``wo`` is whole."""
    h, kv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    lo, hi, partial = sh.local_range(params["wo"]["kernel"].shape[-2], h * hd)
    g = h // kv
    q0, q1 = lo // hd, -(-hi // hd)
    if q0 // g != (q1 - 1) // g and (q0 % g or q1 % g):
        q0, q1 = q0 // g * g, -(-q1 // g) * g      # whole groups
    return HeadPlan(q0, q1, q0 // g, (q1 - 1) // g + 1, lo, hi, partial, hd)


def _qkv_params(params, spec: AttnSpec, plan: HeadPlan) -> dict:
    """``wq``/``wk``/``wv`` (kernel, bias) restricted to the plan's heads."""
    hd = spec.head_dim
    cols = {"wq": (plan.q0 * hd, plan.q1 * hd, spec.num_heads * hd),
            "wk": (plan.k0 * hd, plan.k1 * hd, spec.num_kv_heads * hd),
            "wv": (plan.k0 * hd, plan.k1 * hd, spec.num_kv_heads * hd)}
    return {
        name: {key: sh.take(leaf, -1, *cols[name], plan.partial,
                            f"attention/{name}")
               for key, leaf in params[name].items()}
        for name in cols
    }


def _project_qkv(params, x, spec: AttnSpec, positions, compute_dtype):
    """q ``[B, S, Hq, Dh]``, k/v ``[B, S, Hkv, Dh]`` at the head counts of
    the weights given (the local ones under tensor parallelism)."""
    b, s, _ = x.shape
    q = layers.dense_apply(params["wq"], x, compute_dtype).reshape(
        b, s, -1, spec.head_dim
    )
    k = layers.dense_apply(params["wk"], x, compute_dtype).reshape(
        b, s, -1, spec.head_dim
    )
    v = layers.dense_apply(params["wv"], x, compute_dtype).reshape(
        b, s, -1, spec.head_dim
    )
    if spec.rope_theta > 0:  # theta == 0 ⇒ NoPE (e.g. Jamba attention)
        q = layers.apply_rope(q, positions, spec.rope_theta)
        k = layers.apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _local(params, x, spec: AttnSpec):
    """(the q/k/v weights, the block input and the plan) of this rank:
    ``params`` and ``x`` themselves, and None, without tensor
    parallelism."""
    if sh.tp() is None:
        return params, x, None
    plan = head_plan(params, spec)
    if plan.partial:
        x = sh.copy_to_tp(x)
    return _qkv_params(params, spec, plan), x, plan


def _out(params, out, plan: HeadPlan | None, compute_dtype):
    """``wo`` on the heads' output ``[B, S, Hq·Dh]``: its slice at ``wo``'s
    local rows, then the sum over the TP ranks where it is partial (the
    bias, if any, added once after it)."""
    if plan is not None and out.shape[-1] != plan.hi - plan.lo:
        start = plan.lo - plan.q0 * plan.head_dim
        out = out[..., start:start + plan.hi - plan.lo]
    return layers.row_split_apply(params["wo"], out, compute_dtype,
                                  plan is not None and plan.partial)


def _sdpa(q, k, v, mask, spec: AttnSpec, compute_dtype):
    """Grouped scaled-dot-product attention. q:[B,Sq,H,D] k/v:[B,Sk,Hkv,D];
    mask:[B,Sq,Sk] boolean, True = attend."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
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


def _sdpa_chunked(q, k, v, spec: AttnSpec, compute_dtype, window):
    """Online-softmax attention in plain torch ops: a loop over k chunks
    inside a loop over q chunks, never more than ``[B, H, CQ, CK]`` logits
    at once — the reference's ``_sdpa_chunked`` (same math, float32
    probabilities). Chunks wholly beyond causal reach are not visited: in
    the reference they add ``exp(NEG_INF − m) = 0`` with ``alpha = 1``, so
    the result is the same. Differentiable (the training form)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    groups = h // kv
    cq, ck = min(CHUNK_Q, s), min(CHUNK_K, s)
    nq, nk = s // cq, s // ck
    qg = q.reshape(b, nq, cq, kv, groups, d).to(torch.float32)
    kg = k.reshape(b, nk, ck, kv, d).to(torch.float32)
    vg = v.reshape(b, nk, ck, kv, d).to(torch.float32)
    outs = []
    for iq in range(nq):
        qpos = iq * cq + torch.arange(cq, device=q.device)
        m = torch.full((b, kv, groups, cq), -torch.inf, device=q.device)
        l = torch.zeros((b, kv, groups, cq), device=q.device)
        acc = torch.zeros((b, kv, groups, cq, d), device=q.device)
        for ik in range(nk):
            if ik * ck > (iq + 1) * cq - 1:
                break
            logits = torch.einsum(
                "bqkgd,bskd->bkgqs", qg[:, iq], kg[:, ik]
            ) * (d**-0.5)
            logits = layers.softcap(logits, spec.softcap)
            kpos = ik * ck + torch.arange(ck, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            logits = logits.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vg[:, ik]
            )
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # [b, cq, kv, groups, d]
    out = torch.stack(outs, dim=1).reshape(b, s, h, d)
    return out.to(compute_dtype)


def apply_train(
    params, x, spec: AttnSpec, compute_dtype, window_override=None
) -> torch.Tensor:
    """Full-sequence training attention. x: [B, S, D]."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    qkv, x, plan = _local(params, x, spec)
    q, k, v = _project_qkv(qkv, x, spec, positions, compute_dtype)
    window = spec.window if window_override is None else window_override
    if s >= CHUNKED_ATTN_THRESHOLD and s % CHUNK_Q == 0 and s % CHUNK_K == 0:
        out = _sdpa_chunked(q, k, v, spec, compute_dtype, window)
    else:
        mask = causal_mask(s, s, window, x.device).expand(b, s, s)
        out = _sdpa(q, k, v, mask, spec, compute_dtype)
    return _out(params, out.reshape(b, s, -1), plan, compute_dtype)


def init_cache(batch: int, max_len: int, spec: AttnSpec, dtype, device,
               lead=(), params=None) -> dict:
    """Empty K/V of ``spec.num_kv_heads`` heads, or of this rank's KV
    heads under tensor parallelism when ``params`` (the layer's local
    weights, stacked or not) are given."""
    s_cache = min(max_len, spec.window) if spec.window else max_len
    kv = spec.num_kv_heads
    if params is not None and sh.tp() is not None:
        plan = head_plan(params, spec)
        kv = plan.k1 - plan.k0
    shape = (*lead, batch, s_cache, kv, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros(lead, dtype=torch.int32, device=device),
    }


def apply_decode(
    params, x, cache, spec: AttnSpec, compute_dtype
) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: [B, 1, D]; cache as from ``init_cache``.

    Sliding-window layers use the cache as a ring buffer (slot = pos mod
    S_cache, valid slots < min(pos+1, S_cache)); global layers append at
    pos (valid slots ≤ pos) — the reference's valid set. The new K/V row
    is written into ``cache`` in place and ``cache["pos"]`` is advanced in
    place; the same dict is returned. Attention goes through
    ``ops.decode_attention`` with ``length`` as a device tensor.
    """
    b = x.shape[0]
    pos = cache["pos"]
    qkv, x, plan = _local(params, x, spec)
    q, k_new, v_new = _project_qkv(
        qkv, x, spec, pos.expand(b, 1), compute_dtype
    )
    s_cache = cache["k"].shape[1]
    if spec.window is not None:
        slot = torch.remainder(pos, s_cache)
        length = torch.clamp(pos + 1, max=s_cache)
    else:
        slot = pos
        length = pos + 1
    slot = slot.reshape(1).to(torch.int64)
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    out = ops.decode_attention(
        q.transpose(1, 2), cache["k"].transpose(1, 2),
        cache["v"].transpose(1, 2), length.to(torch.int32),
        softcap=spec.softcap,
    )
    out = _out(params, out.transpose(1, 2).reshape(b, 1, -1), plan,
               compute_dtype)
    cache["pos"].add_(1)
    return out, cache


def prefill_cache(
    params, x, spec: AttnSpec, compute_dtype, max_len: int, cache=None
) -> tuple[torch.Tensor, dict]:
    """Full-sequence attention AND the decode cache. x: [B, S, D].

    Attention goes through ``ops.flash_attention`` (causal, the layer's
    window and softcap) at every length. The cache is written into
    ``cache`` when given (a slice of the stacked caches, so nothing is
    copied afterwards), else into a new one from ``init_cache``: the
    prompt's K/V at slots ``0..S-1`` and zeros after them, or for a
    sliding-window layer whose window the prompt fills, the last
    ``S_cache`` positions each at its ring slot ``p mod S_cache``.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    qkv, x, plan = _local(params, x, spec)
    q, k, v = _project_qkv(qkv, x, spec, positions, compute_dtype)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=spec.window, softcap=spec.softcap,
    )
    y = _out(params, out.transpose(1, 2).reshape(b, s, -1), plan,
             compute_dtype)

    if cache is None:
        cache = init_cache(b, max_len, spec, compute_dtype, x.device,
                           params=params)
    s_cache = cache["k"].shape[1]
    if spec.window is not None and s >= s_cache:
        tail = s - s_cache
        slots = torch.arange(tail, s, device=x.device) % s_cache
        cache["k"].index_copy_(1, slots, k[:, tail:].to(cache["k"].dtype))
        cache["v"].index_copy_(1, slots, v[:, tail:].to(cache["v"].dtype))
    else:
        if s > s_cache:
            raise ValueError(f"prompt of {s} tokens > max_len {s_cache}")
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["k"][:, s:] = 0
        cache["v"][:, s:] = 0
    cache["pos"].fill_(s)
    return y, cache
