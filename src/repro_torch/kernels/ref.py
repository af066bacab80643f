"""Plain PyTorch versions of the port's kernels (the oracle in tests).

Counterpart of the JAX package's ``kernels/ref.py``: the mixing combine
and the two attention functions, in float32 with the kernels' mask
constant; then the port's own recurrent kernels, which the JAX package
leaves to XLA's scans: Mamba's selective scan and sLSTM's recurrence, each
forward and backward (the backward as an explicit reverse recurrence, not
autograd). Two differences by design from the JAX oracles, shared with the
CUDA kernels: a query row with no valid key (``length = 0`` in decode, a
row outside every key's reach in prefill) gives zeros, as the Pallas
kernels do, where the JAX oracle softmaxes a row of ``-1e30`` into a
uniform average of V; and any ``Sq``/``Sk``/``S`` is accepted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Mamba's selective scan
# ---------------------------------------------------------------------------


def selective_scan_ref(u, dt, a, bm, cm, h0=None, chunk: int = 256):
    """``h_t = exp(dt_t·A)·h_{t-1} + (dt_t·B_t)·u_t``, ``y_t = Σ_n h_t·C_t``
    over ``u [B, S, di]`` (any float dtype), float32 ``dt [B, S, di]``,
    ``a [di, ds]``, ``bm``/``cm [B, S, ds]`` and ``h0 [B, di, ds]`` (zeros
    when None) → (``y [B, S, di]``, the last ``h``), both float32.

    Runs in chunks of ``chunk`` steps along S: a chunk's decay and input
    ``[B, L, di, ds]`` are made at once, then a loop over its steps carries
    ``h`` with one ``addcmul`` a step."""
    b, s, di = u.shape
    h = (torch.zeros((b, di, a.shape[-1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0)
    ys = []
    for c0 in range(0, s, chunk):
        part = slice(c0, min(c0 + chunk, s))
        dtc = dt[:, part, :, None]
        decay = torch.exp(dtc * a)                              # [B,L,di,ds]
        bu = (dtc * bm[:, part, None, :]) * u[:, part].to(
            torch.float32)[..., None]
        hs = []
        for t in range(decay.shape[1]):
            h = torch.addcmul(bu[:, t], decay[:, t], h)
            hs.append(h)
        del decay, bu
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1),
                               cm[:, part]))
        del hs
    y = torch.cat(ys, dim=1) if ys else u.new_zeros(u.shape, dtype=torch.float32)
    return y, h


def selective_scan_bwd_ref(u, dt, a, bm, cm, h0, dy, dh_last=None):
    """The gradient of ``selective_scan_ref``'s (y, last h) as a reverse
    recurrence: ``g_t = C_t·dy_t + exp(dt_{t+1}·A)·g_{t+1}`` from ``g`` =
    ``dh_last`` past the end, then each input's share. Returns float32
    (``du``, ``ddt``, ``da``, ``dbm``, ``dcm``, ``dh0``); ``h0`` None is
    zeros."""
    b, s, di = u.shape
    uf = u.to(torch.float32)
    h = (torch.zeros((b, di, a.shape[-1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0)
    decay = torch.exp(dt[..., None] * a)                        # [B,S,di,ds]
    bu = (dt[..., None] * bm[:, :, None, :]) * uf[..., None]
    hs = []
    for t in range(s):
        h = torch.addcmul(bu[:, t], decay[:, t], h)
        hs.append(h)
    del bu
    hs = torch.stack(hs, dim=1)
    g = torch.zeros_like(h) if dh_last is None else dh_last.to(torch.float32)
    gs = [None] * s
    for t in range(s - 1, -1, -1):
        g = cm[:, t, None, :] * dy[:, t, :, None] + g
        gs[t] = g
        g = decay[:, t] * g
    dh0 = g
    gs = torch.stack(gs, dim=1)                                 # dL/dh_t
    hprev = torch.cat([(torch.zeros_like(hs[:, :1]) if h0 is None
                        else h0[:, None]), hs[:, :-1]], dim=1)
    dcm = torch.einsum("bsdn,bsd->bsn", hs, dy)
    del hs
    dbm = torch.einsum("bsdn,bsd->bsn", gs, dt * uf)
    du = torch.einsum("bsdn,bsn->bsd", gs, bm) * dt
    gd = gs * hprev * decay                                     # dL/d(dt·A)
    del hprev, decay
    ddt = (torch.einsum("bsdn,bsn->bsd", gs, bm) * uf
           + torch.einsum("bsdn,dn->bsd", gd, a))
    da = torch.einsum("bsdn,bsd->dn", gd, dt)
    return du, ddt, da, dbm, dcm, dh0


# ---------------------------------------------------------------------------
# sLSTM's recurrence
# ---------------------------------------------------------------------------


def _slstm_update(pre, state):
    """The cell after its pre-activations ``pre [B, 4·d]`` (float32):
    exponential gating with the stabilizer m (xLSTM eqs.)."""
    zt, itil, ftil, ot = pre.chunk(4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    logf = F.logsigmoid(ftil)
    m_new = torch.maximum(logf + state["m"], itil)
    iw = torch.exp(itil - m_new)
    fw = torch.exp(logf + state["m"] - m_new)
    c = fw * state["c"] + iw * z
    n = fw * state["n"] + iw
    h = o * (c / torch.maximum(n, torch.exp(-m_new) + 1e-6))
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_step_ref(pre_x, r, state):
    """One sLSTM step: ``pre_x [B, 4·d]`` the step's input projections
    (float32), ``r [d, 4·d]`` the recurrent weights in the compute dtype,
    whose product with ``h`` is rounded to that dtype before it is added;
    ``state`` the carry ``{c, n, h, m}`` (float32) → the new carry."""
    pre = pre_x + (state["h"].to(r.dtype) @ r).to(torch.float32)
    return _slstm_update(pre, state)


def slstm_scan_ref(pre_x, r, carry):
    """``slstm_step_ref`` over ``pre_x [B, S, 4·d]`` from ``carry`` →
    (``hs [B, S, d]`` float32, the last carry)."""
    hs = []
    for t in range(pre_x.shape[1]):
        carry = slstm_step_ref(pre_x[:, t], r, carry)
        hs.append(carry["h"])
    return torch.stack(hs, dim=1), carry


def _max_share(x, y):
    """autograd's gradient share of ``x`` in ``maximum(x, y)``: 1 where it
    is the larger, 1/2 on a tie."""
    return (x > y).to(x.dtype) + 0.5 * (x == y).to(x.dtype)


def _bf16_once(x):
    """float64 ``x`` rounded to bfloat16 in one step, to nearest with ties
    to even: its 52-bit fraction cut to bfloat16's 7 (torch's float64 →
    bfloat16 cast rounds to float32 first, a second rounding). Values below
    bfloat16's normals are rounded again by the cast."""
    bits = x.view(torch.int64)
    bits = (bits + (1 << 44) - 1 + ((bits >> 45) & 1)) & -(1 << 45)
    return bits.view(torch.float64).to(torch.bfloat16)


def slstm_scan_bwd_ref(pre_x, r, carry0, dhs, dlast=None, saved=None,
                       exact=False):
    """The gradient of ``slstm_scan_ref``'s (hs, last carry) as a reverse
    recurrence, with autograd's rules (``maximum``'s ties split in halves;
    the recurrent product's gradient ``round(round(dpre_t) @ rᵀ)`` in
    r's dtype) → (``dpre [B, S, 4·d]``, the initial carry's gradient
    ``{c, n, h, m}``), float32. ``dlast`` is the last carry's gradient
    (zeros when None). ``saved``: the forward's pre-activations ``[B, S,
    4·d]`` and (c, n, m) ``[3, B, S, d]`` of every step, as the kernel's
    forward saves them, in place of the forward recomputed from ``pre_x``
    (a near-tie of ``maximum`` in the forward decides where the gradient
    goes, so a backward is held on the forward it is given). ``exact``: the
    recurrent product summed in float64 and rounded to r's dtype once —
    the exact sum's rounding, which the card's bf16 backward computes and
    against which it is held."""
    if saved is None:
        states, pres = [carry0], []
        for t in range(pre_x.shape[1]):
            pre = pre_x[:, t] + (states[-1]["h"].to(r.dtype) @ r).to(
                torch.float32)
            pres.append(pre)
            states.append(_slstm_update(pre, states[-1]))
    else:
        pre, st = saved
        pres = pre.unbind(1)
        states = [carry0] + [dict(zip("cnm", step))
                             for step in st.unbind(2)]
    s = len(pres)
    zero = torch.zeros_like(carry0["c"])
    grad = dict.fromkeys("cnhm", zero) if dlast is None else dlast
    dc, dn, dm, dh_rec = grad["c"], grad["n"], grad["m"], grad["h"]
    dpre = [None] * s
    for t in range(s - 1, -1, -1):
        prev, new = states[t], states[t + 1]
        pz, pi, pf, po = pres[t].chunk(4, dim=-1)
        z, o, lf = torch.tanh(pz), torch.sigmoid(po), F.logsigmoid(pf)
        iw = torch.exp(pi - new["m"])
        fw = torch.exp(lf + prev["m"] - new["m"])
        ex = torch.exp(-new["m"])
        floor = ex + 1e-6
        den = torch.maximum(new["n"], floor)
        dh = dhs[:, t] + dh_rec
        d_o = dh * (new["c"] / den)
        dq = dh * o
        dc1 = dc + dq / den
        dden = -dq * new["c"] / (den * den)
        dn1 = dn + dden * _max_share(new["n"], floor)
        dm1 = dm - dden * _max_share(floor, new["n"]) * ex
        dfw = dn1 * prev["n"] + dc1 * prev["c"]
        diw = dn1 + dc1 * z
        dz = dc1 * iw
        dpi = diw * iw
        dm1 = dm1 - diw * iw
        dfa = dfw * fw
        dm1 = dm1 - dfa
        fm = lf + prev["m"]
        d_fm = dm1 * _max_share(fm, pi)
        dpi = dpi + dm1 * _max_share(pi, fm)
        dlf = dfa + d_fm
        dm = dfa + d_fm
        dpf = dlf * torch.sigmoid(-pf)
        dpo = d_o * (1 - o) * o
        dpz = dz * (1 - z * z)
        dpre[t] = torch.cat([dpz, dpi, dpf, dpo], dim=-1)
        rounded = dpre[t].to(r.dtype)
        if exact:
            total = rounded.double() @ r.double().T
            dh_rec = (_bf16_once(total) if r.dtype == torch.bfloat16
                      else total.to(r.dtype)).to(torch.float32)
        else:
            dh_rec = (rounded @ r.T).to(torch.float32)
        dc, dn = dc1 * fw, dn1 * fw
    return torch.stack(dpre, dim=1), {"c": dc, "n": dn, "h": dh_rec, "m": dm}
