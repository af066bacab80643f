"""Recurrent sequence mixers: Mamba (Jamba) and mLSTM / sLSTM (xLSTM).

Counterpart of the JAX package's ``models/ssm.py``, as plain functions on
dicts of tensors with an explicit generator and device (``lead``: leading
stack dimensions, the group axis G, as in ``models/layers.py``). Each
mixer provides

  *_init(generator, spec, dtype, device, lead=())         -> params
  *_apply_train(params, x, spec, compute_dtype)           -> y
  *_prefill(params, x, spec, compute_dtype)               -> (y, state)
  *_init_state(batch, spec, [dtype,] device, lead=())     -> state
  *_apply_decode(params, x, state, spec, compute_dtype)   -> (y, state)

(Only Mamba's state takes a dtype, the compute dtype of its conv inputs;
every other state leaf is float32.)

``*_apply_decode`` is one O(1) step of the recurrence and returns a new
state, as the reference's; the blocks write it into the caches in place.

Where the port departs from the reference's calls, not its results:

* Mamba's scan runs in chunks of SCAN_CHUNK steps along S. A chunk's
  decay and input, ``[B, L, d_inner, d_state]`` float32, are made at
  once; a loop over its steps then carries ``h [B, d_inner, d_state]``
  with the decode form's update, one ``addcmul`` a step. The reference's
  associative scan materialises ``[B, S, d_inner, d_state]`` several times
  over (17.2 GB each at Jamba's served 2 × 8192 tokens). The products are
  taken in another order than the scan's.
* mLSTM's quadratic form is laid out ``[B, H, S, S]`` for batched matmuls.
* sLSTM's four input projections are one product over all S before its
  loop over time, its four recurrent ones one product a step.
* ``*_prefill`` returns the train form's output and the decode state after
  the last token from the same pass: Mamba's last ``h`` and last
  ``d_conv - 1`` inputs, mLSTM's state in closed form from the last row of
  its decay matrix (``m_S = max_j(fcum_S - fcum_j + i_j)``, ``c``, ``n``
  weighted by that row), sLSTM's loop carry. The reference's
  ``blocks.prefill`` steps the decode form S times for it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models import sharding_hints as sh

# Steps of Mamba's scan whose decay and input are made at once.
SCAN_CHUNK = 256


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — Jamba's sequence mixer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


def mamba_init(generator, spec: MambaSpec, dtype, device, lead=()) -> dict:
    di, ds = spec.d_inner, spec.d_state
    # S4D-real initialization for A (negative reals); a_log stays float32.
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=device)
    dt_bias = torch.log(torch.expm1(
        torch.full((*lead, di), 1e-2, dtype=torch.float32, device=device)))
    return {
        "in_proj": layers.dense_init(
            generator, spec.d_model, 2 * di, dtype, device, lead),
        "conv": layers.truncated_normal_init(
            generator, (*lead, spec.d_conv, di), spec.d_conv**-0.5, dtype,
            device),
        "conv_bias": torch.zeros((*lead, di), dtype=dtype, device=device),
        "x_proj": layers.dense_init(
            generator, di, ds * 2 + 1, dtype, device, lead),
        "dt_bias": dt_bias.to(dtype),
        "dt_proj": layers.dense_init(generator, 1, di, dtype, device, lead),
        "a_log": torch.log(a).expand(*lead, di, ds).contiguous(),
        "d_skip": torch.ones((*lead, di), dtype=dtype, device=device),
        "out_proj": layers.dense_init(
            generator, di, spec.d_model, dtype, device, lead),
    }


def _mamba_local(params, x, spec: MambaSpec):
    """(the leaves at this rank's block of d_inner, the mixer's input, and
    whether the output is a partial sum over the TP ranks): ``params`` and
    ``x`` themselves without tensor parallelism. The block is ``out_proj``'s
    local rows; ``in_proj``'s contiguous column split cuts across ``[u |
    z]``, so it is gathered whole and the block's ``u`` and ``z`` columns
    taken from it."""
    if sh.tp() is None:
        return params, x, False
    di = spec.d_inner
    lo, hi, partial = sh.local_range(params["out_proj"]["kernel"].shape[-2],
                                     di)
    if partial:
        x = sh.copy_to_tp(x)
    w = sh.take(params["in_proj"]["kernel"], -1, 0, 2 * di, 2 * di, partial,
                "mamba/in_proj")
    local = dict(params)
    local["in_proj"] = {"kernel": torch.cat(
        [w[..., lo:hi], w[..., di + lo:di + hi]], dim=-1)}
    for name, dim in (("conv", -1), ("conv_bias", -1), ("dt_bias", -1),
                      ("d_skip", -1), ("a_log", -2)):
        local[name] = sh.take(params[name], dim, lo, hi, di, partial)
    for name, dim in (("dt_proj", -1), ("x_proj", -2)):
        local[name] = {"kernel": sh.take(params[name]["kernel"], dim, lo, hi,
                                         di, partial)}
    return local, x, partial


def _mamba_gates(params, u, spec: MambaSpec, partial: bool = False):
    """Input-dependent SSM parameters of the post-conv ``u [B, S, d_inner]``:
    (dt ``[B, S, d_inner]``, A ``[d_inner, d_state]``, B and C ``[B, S,
    d_state]``), float32. Under tensor parallelism ``x_proj``'s local rows
    give a partial sum, summed over the ranks and then used by each rank's
    block (so its gradient is summed too)."""
    proj = layers.dense_apply(params["x_proj"], u, torch.float32)
    if partial:
        proj = sh.copy_to_tp(sh.reduce_from_tp(proj))
    dt_raw, bmat, cmat = torch.split(
        proj, [1, spec.d_state, spec.d_state], dim=-1)
    dt = _softplus(
        layers.dense_apply(params["dt_proj"], dt_raw, torch.float32)
        + params["dt_bias"].to(torch.float32)
    )
    a = -torch.exp(params["a_log"].to(torch.float32))
    return dt, a, bmat, cmat


def _mamba_out(params, y32, uc, z, compute_dtype, partial: bool = False):
    y = y32.to(compute_dtype) + params["d_skip"].to(compute_dtype) * uc
    y = y * F.silu(z)
    return layers.row_split_apply(params["out_proj"], y, compute_dtype,
                                  partial)


def mamba_prefill(params, x, spec: MambaSpec, compute_dtype):
    """x: ``[B, S, D]`` → (y ``[B, S, D]``, the decode state after token S).
    Causal depthwise conv over ``d_conv - 1`` zeros on the left, then the
    chunked scan ``h_t = decay_t · h_{t-1} + bu_t``."""
    b, s, _ = x.shape
    params, x, partial = _mamba_local(params, x, spec)
    ds, dc = spec.d_state, spec.d_conv
    xz = layers.dense_apply(params["in_proj"], x, compute_dtype)
    u, z = xz.chunk(2, dim=-1)                                  # [B, S, di]
    di = u.shape[-1]                       # this rank's block under TP
    w = params["conv"].to(compute_dtype)                        # [dc, di]
    upad = torch.cat([u.new_zeros((b, dc - 1, di)), u], dim=1)
    uc = sum(w[i] * upad[:, i:i + s] for i in range(dc))
    uc = F.silu(uc + params["conv_bias"].to(compute_dtype))

    dt, a, bmat, cmat = _mamba_gates(params, uc, spec, partial)
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, SCAN_CHUNK):
        part = slice(c0, min(c0 + SCAN_CHUNK, s))
        dtc = dt[:, part, :, None]
        decay = torch.exp(dtc * a)                              # [B,L,di,ds]
        bu = (dtc * bmat[:, part, None, :]) * uc[:, part].to(
            torch.float32)[..., None]
        hs = []
        for t in range(decay.shape[1]):
            h = torch.addcmul(bu[:, t], decay[:, t], h)
            hs.append(h)
        del decay, bu
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1),
                               cmat[:, part]).to(compute_dtype))
        del hs
    y = _mamba_out(params, torch.cat(ys, dim=1), uc, z, compute_dtype,
                   partial)
    return y, {"conv": upad[:, s:], "ssm": h}


def mamba_apply_train(params, x, spec: MambaSpec, compute_dtype):
    """x: [B, S, D] -> [B, S, D]."""
    return mamba_prefill(params, x, spec, compute_dtype)[0]


def mamba_init_state(batch: int, spec: MambaSpec, dtype, device,
                     lead=(), params=None) -> dict:
    """The empty state; at this rank's block of d_inner (``out_proj``'s
    rows) when the mixer's local ``params`` are given."""
    di = spec.d_inner if params is None else \
        params["out_proj"]["kernel"].shape[-2]
    return {
        "conv": torch.zeros((*lead, batch, spec.d_conv - 1, di),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, di, spec.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_apply_decode(params, x, state, spec: MambaSpec, compute_dtype):
    """Single-step recurrence. x: [B, 1, D]."""
    params, x, partial = _mamba_local(params, x, spec)
    xz = layers.dense_apply(params["in_proj"], x, compute_dtype)
    u, z = xz.chunk(2, dim=-1)                                  # [B, 1, di]
    hist = torch.cat([state["conv"], u], dim=1)                 # [B, dc, di]
    w = params["conv"].to(compute_dtype)
    uc = torch.einsum("bcd,cd->bd", hist, w) + params["conv_bias"].to(
        compute_dtype)
    uc = F.silu(uc)[:, None, :]                                 # [B, 1, di]

    dt, a, bmat, cmat = _mamba_gates(params, uc, spec, partial)
    dt0 = dt[:, 0, :, None]
    h = (state["ssm"] * torch.exp(dt0 * a)
         + (dt0 * bmat[:, 0, None, :]) * uc.to(torch.float32)[:, 0, :, None])
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None, :]
    return _mamba_out(params, y, uc, z, compute_dtype, partial), {
        "conv": hist[:, 1:], "ssm": h}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory block) — parallel + recurrent forms
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLSTMSpec:
    d_model: int
    num_heads: int
    proj_factor: int = 2  # d_inner = proj_factor · d_model (xLSTM block)

    @property
    def d_inner(self) -> int:
        return self.proj_factor * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.num_heads


def mlstm_init(generator, spec: MLSTMSpec, dtype, device, lead=()) -> dict:
    """xLSTM mLSTM block: up-proj (x, z), per-head block-diagonal q/k/v,
    exponential gates, matrix memory, gated down-proj."""
    d, di, h, hd = spec.d_model, spec.d_inner, spec.num_heads, spec.head_dim

    def blockdiag():
        return layers.truncated_normal_init(
            generator, (*lead, h, hd, hd), hd**-0.5, dtype, device)

    return {
        "up": layers.dense_init(generator, d, 2 * di, dtype, device, lead),
        "wq": blockdiag(),
        "wk": blockdiag(),
        "wv": blockdiag(),
        "wi": layers.dense_init_bias(generator, d, h, dtype, device, lead),
        "wf": layers.dense_init_bias(generator, d, h, dtype, device, lead),
        "down": layers.dense_init(generator, di, d, dtype, device, lead),
    }


def _mlstm_qkv(params, x, spec: MLSTMSpec, compute_dtype):
    """q, k, v ``[B, S, H, hd]``, float32 gates ``[B, S, H]`` and the z
    gating stream ``[B, S, d_inner]``."""
    b, s, _ = x.shape
    h, hd = spec.num_heads, spec.head_dim
    xz = layers.dense_apply(params["up"], x, compute_dtype)
    xin, z = xz.chunk(2, dim=-1)
    xh = xin.reshape(b, s, h, hd)
    q = torch.einsum("bshd,hde->bshe", xh, params["wq"].to(compute_dtype))
    k = torch.einsum(
        "bshd,hde->bshe", xh, params["wk"].to(compute_dtype)) * (hd**-0.5)
    v = torch.einsum("bshd,hde->bshe", xh, params["wv"].to(compute_dtype))
    igate = layers.dense_apply(params["wi"], x, torch.float32)
    fgate = layers.dense_apply(params["wf"], x, torch.float32)
    return q, k, v, igate, fgate, z


def mlstm_prefill(params, x, spec: MLSTMSpec, compute_dtype):
    """Stabilized parallel (quadratic) form (xLSTM paper, eq. 2x) → (y, the
    decode state after token S).

    D_ij = exp(fcum_i − fcum_j + i_j − m_i) for j ≤ i, with the row max
    m_i as stabilizer and normalizer max(|Σ_j|, exp(−m_i)). The state is
    the last row's: ``m = m_S``, ``c = Σ_j D_Sj k_j v_jᵀ``, ``n = Σ_j D_Sj
    k_j``, which is what S decode steps from the empty state give."""
    b, s, _ = x.shape
    q, k, v, igate, fgate, z = _mlstm_qkv(params, x, spec, compute_dtype)
    fcum = torch.cumsum(F.logsigmoid(fgate), dim=1).transpose(1, 2)
    dmat = (fcum[..., :, None] - fcum[..., None, :]
            + igate.transpose(1, 2)[..., None, :])          # [B, H, i, j]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril_()
    dmat = dmat.masked_fill(~causal, -torch.inf)
    m = dmat.amax(dim=-1, keepdim=True)                     # [B, H, i, 1]
    dexp = torch.exp(dmat - m)
    del dmat
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    wts = (qf @ kf.transpose(-1, -2)) * dexp                # [B, H, i, j]
    norm = torch.maximum(wts.sum(dim=-1).abs(), torch.exp(-m[..., 0]))
    y = (wts @ vf) / (norm[..., None] + 1e-6)               # [B, H, i, hd]
    del wts
    y = y.to(compute_dtype).transpose(1, 2).reshape(b, s, spec.d_inner)
    out = layers.dense_apply(params["down"], y * F.silu(z), compute_dtype)
    last = dexp[..., -1, :]                                 # [B, H, j]
    state = {
        "c": torch.einsum("bhj,bhjd,bhje->bhde", last, kf, vf),
        "n": torch.einsum("bhj,bhjd->bhd", last, kf),
        "m": m[..., -1, 0],
    }
    return out, state


def mlstm_apply_train(params, x, spec: MLSTMSpec, compute_dtype):
    return mlstm_prefill(params, x, spec, compute_dtype)[0]


def mlstm_init_state(batch: int, spec: MLSTMSpec, device, lead=()) -> dict:
    h, hd = spec.num_heads, spec.head_dim
    f32 = torch.float32
    return {
        "c": torch.zeros((*lead, batch, h, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((*lead, batch, h, hd), dtype=f32, device=device),
        "m": torch.full((*lead, batch, h), -torch.inf, dtype=f32,
                        device=device),
    }


def mlstm_apply_decode(params, x, state, spec: MLSTMSpec, compute_dtype):
    """Recurrent mLSTM step (xLSTM paper eqs. 19-27). x: [B, 1, D]. From
    the empty state (``m = -inf``) the forget weight is exp(-inf) = 0."""
    b = x.shape[0]
    q, k, v, igate, fgate, z = _mlstm_qkv(params, x, spec, compute_dtype)
    qf, kf, vf = (t[:, 0].to(torch.float32) for t in (q, k, v))  # [b,h,hd]
    i_t, logf = igate[:, 0], F.logsigmoid(fgate[:, 0])           # [b,h]
    m_new = torch.maximum(logf + state["m"], i_t)
    fw = torch.exp(logf + state["m"] - m_new)[..., None]
    iw = torch.exp(i_t - m_new)[..., None]
    c = state["c"] * fw[..., None] + iw[..., None] * (
        kf[..., :, None] * vf[..., None, :])
    n = state["n"] * fw + iw * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                        torch.exp(-m_new))
    y = (num / (den[..., None] + 1e-6)).to(compute_dtype)
    y = y.reshape(b, 1, spec.d_inner) * F.silu(z)
    out = layers.dense_apply(params["down"], y, compute_dtype)
    return out, {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar-memory block) — inherently sequential
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLSTMSpec:
    d_model: int
    num_heads: int  # gates use full projections, as the reference's


_GATES = ("z", "i", "f", "o")


def slstm_init(generator, spec: SLSTMSpec, dtype, device, lead=()) -> dict:
    d = spec.d_model
    p = {f"w{g}": layers.dense_init_bias(generator, d, d, dtype, device, lead)
         for g in _GATES}
    # Recurrent weights.
    p.update({f"r{g}": layers.truncated_normal_init(
        generator, (*lead, d, d), d**-0.5, dtype, device) for g in _GATES})
    p["out"] = layers.dense_init(generator, d, d, dtype, device, lead)
    return p


def slstm_init_state(batch: int, spec: SLSTMSpec, device, lead=()) -> dict:
    shape = (*lead, batch, spec.d_model)
    f32 = torch.float32
    return {
        "c": torch.zeros(shape, dtype=f32, device=device),
        "n": torch.zeros(shape, dtype=f32, device=device),
        "h": torch.zeros(shape, dtype=f32, device=device),
        "m": torch.full(shape, -torch.inf, dtype=f32, device=device),
    }


def _slstm_input(params, x):
    """The four gates' input projections ``[..., 4·d]`` in float32. Under
    tensor parallelism the rule splits ``wo``'s rows alone (its path
    matches attention's ``wo``); it is gathered whole here."""
    d = params["wz"]["kernel"].shape[-1]
    w = torch.cat([
        sh.take(params[f"w{g}"]["kernel"], -2, 0, d, d, False, "slstm/wo")
        for g in _GATES], dim=-1)
    bias = torch.cat([params[f"w{g}"]["bias"] for g in _GATES], dim=-1)
    return layers.dense_apply({"kernel": w, "bias": bias}, x, torch.float32)


def _slstm_recurrent(params, compute_dtype) -> torch.Tensor:
    return torch.cat([params[f"r{g}"] for g in _GATES], dim=-1).to(
        compute_dtype)


def _slstm_cell(pre_x, r, state, compute_dtype):
    """One sLSTM step with exponential gating + stabilizer (xLSTM eqs.).
    ``pre_x``: the step's input projections ``[B, 4·d]`` (float32), ``r``
    the recurrent weights ``[d, 4·d]`` in the compute dtype."""
    pre = pre_x + (state["h"].to(compute_dtype) @ r).to(torch.float32)
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


def slstm_prefill(params, x, spec: SLSTMSpec, compute_dtype):
    """x: [B, S, D] → (y, the loop's carry after token S); a loop over time
    (sLSTM has no parallel form)."""
    b, s, _ = x.shape
    pre_x = _slstm_input(params, x)                           # [B, S, 4d]
    r = _slstm_recurrent(params, compute_dtype)
    state = slstm_init_state(b, spec, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(pre_x[:, t], r, state, compute_dtype)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(compute_dtype)
    return layers.dense_apply(params["out"], y, compute_dtype), state


def slstm_apply_train(params, x, spec: SLSTMSpec, compute_dtype):
    return slstm_prefill(params, x, spec, compute_dtype)[0]


def slstm_apply_decode(params, x, state, spec: SLSTMSpec, compute_dtype):
    new = _slstm_cell(_slstm_input(params, x[:, 0]),
                      _slstm_recurrent(params, compute_dtype), state,
                      compute_dtype)
    y = new["h"].to(compute_dtype)[:, None, :]
    return layers.dense_apply(params["out"], y, compute_dtype), new
