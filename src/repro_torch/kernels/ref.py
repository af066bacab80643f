"""Plain PyTorch versions of the port's kernels (the oracle in tests).

Counterpart of the JAX package's ``kernels/ref.py``: the mixing combine
and the two attention functions, in float32 with the kernels' mask
constant. Two differences by design from the JAX oracles, shared with the
CUDA kernels: a query row with no valid key (``length = 0`` in decode, a
row outside every key's reach in prefill) gives zeros, as the Pallas
kernels do, where the JAX oracle softmaxes a row of ``-1e30`` into a
uniform average of V; and any ``Sq``/``Sk``/``S`` is accepted.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """``[B, H, Sq, D]`` → ``[B, KV, G, Sq, D]`` in float32: query head
    ``h`` belongs to KV head ``h // G`` (GQA)."""
    b, h, sq, d = q.shape
    if h % kv_heads:
        raise ValueError(f"{h} query heads are not a multiple of {kv_heads}")
    return q.to(torch.float32).reshape(b, kv_heads, h // kv_heads, sq, d)


def _softmax_pv(s: torch.Tensor, valid: torch.Tensor, v: torch.Tensor):
    """Masked softmax of logits ``s [B,KV,G,Sq,Sk]`` (``valid`` broadcasts)
    times ``v [B,KV,Sk,D]``; rows without a valid key give zeros."""
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~valid, 0.0)
    return torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """q ``[B,H,Sq,D]``; k/v ``[B,KV,Sk,D]`` → ``[B,H,Sq,D]`` in q's dtype.

    Key ``j`` is valid for query ``i`` when ``j ≤ i`` (causal) and
    ``j > i − window`` (window); logits are ``(q·k)·D^-0.5``, then
    ``cap·tanh(s/cap)``, then masked. float32 throughout.
    """
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = _grouped(q, kv)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * d**-0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    out = _softmax_pv(s, valid, v)
    return out.reshape(b, h, sq, d).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    length: torch.Tensor | int,
    *,
    softcap: float | None = None,
) -> torch.Tensor:
    """q ``[B,H,1,D]``; k/v ``[B,KV,S,D]``; ``length`` ``[]`` or ``[B]``:
    slots ``≥ length`` are masked. ``length = 0`` gives zeros. Reads
    nothing back to the host."""
    b, h, one, d = q.shape
    kv, s_len = k.shape[1], k.shape[2]
    qg = _grouped(q, kv)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * d**-0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    lengths = torch.as_tensor(length, device=q.device).to(torch.int64)
    lengths = lengths.expand(b)
    valid = torch.arange(s_len, device=q.device)[None, :] < lengths[:, None]
    out = _softmax_pv(s, valid[:, None, None, None, :], v)
    return out.reshape(b, h, one, d).to(q.dtype)


def mixing_sgd_combine_ref(
    x: torch.Tensor,
    recv: torch.Tensor,
    weights: torch.Tensor,
    momentum: torch.Tensor | None = None,
    *,
    lr: float | None = None,
) -> torch.Tensor:
    """``W_ii·x + Σ_r W_{i,j_r}·recv[r] − lr·momentum`` for one agent.

    x ``[N]``, recv ``[R, N]``, weights ``[R+1]``, momentum ``[N]``;
    float32 accumulation, one cast back to ``x.dtype``. With
    ``momentum=None`` the last term is absent (the mix alone).
    """
    w = weights.to(torch.float32)
    acc = x.to(torch.float32) * w[0]
    acc = acc + torch.einsum("r,rn->n", w[1:], recv.to(torch.float32))
    if momentum is not None:
        acc = acc - lr * momentum.to(torch.float32)
    return acc.to(x.dtype)


def mixing_sgd_combine_stacked_ref(
    x: torch.Tensor,
    idx: torch.Tensor,
    weights: torch.Tensor,
    g: torch.Tensor | None = None,
    *,
    lr: float | None = None,
) -> torch.Tensor:
    """All agents at once over the stacked axis (eq. (2) of the paper).

    ``out[a] = w[a,0]·x[a] + Σ_r w[a,r+1]·x[idx[a,r]] − lr·g[a]`` with
    x, g ``[A, N]``, idx ``int32[A, R]``, weights ``fp32[A, R+1]``;
    float32 accumulation, one cast back to ``x.dtype``. With ``g=None``
    the last term is absent (the mix alone). Returns a new tensor; ``x``
    is not written.
    """
    w = weights.to(torch.float32)
    acc = x.to(torch.float32) * w[:, 0:1]
    for r in range(idx.shape[1]):
        rows = x.index_select(0, idx[:, r].to(torch.int64))
        acc = acc + rows.to(torch.float32) * w[:, r + 1 : r + 2]
    if g is not None:
        acc = acc - lr * g.to(torch.float32)
    return acc.to(x.dtype)
