"""Plain float32 reference of an xLSTM language model of the program's kind.

From the xLSTM paper (Beck et al., arXiv:2405.04517): pre-norm residual
blocks with no FFN, in the repeating pattern the configuration gives.

* mLSTM: an up-projection (factor 2) into the cell input and the output
  gate stream z; per head block-diagonal q, k, v (k scaled by hd^-1/2);
  exponential input and sigmoid forget gates from the block input; the
  matrix memory in its stabilized parallel form (the paper's appendix):
  D_ij = exp(F_i − F_j + ĩ_j − m_i) for j ≤ i, F the cumulative log forget
  gate, m_i the row's largest exponent, h_i = (C_i·v) / (max(|Σ_j C_ij|,
  exp(−m_i)) + 1e-6) with C = (q kᵀ) ⊙ D; then (h ⊙ silu(z)) down-projected.
* sLSTM: the four gates (z, i, f, o) from input projections with bias plus
  a full recurrent product of h_{t−1}; exponential input gate and log-sigmoid
  forget gate under the stabilizer m_t = max(log f_t + m_{t−1}, ĩ_t); c, n
  and h_t = o_t · c_t / max(n_t, exp(−m_t) + 1e-6); then an output
  projection. The loop over time is written out plainly, its backward by
  hand (``SLSTMLoop``; held to autograd's in the tests).

Departures from the paper, as the program has them: no causal
convolution, group norm, learnable skip or block-internal FFN; one
RMSNorm before each block; the forget gate's pre-activation in the sLSTM
is a plain projection. The tied embedding is the LM head.

All agents are computed at once (leaves stacked ``[A, …]``), since the
sLSTM loop is thousands of small steps: one loop serves every agent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference.common import Matmul, rmsnorm, token_loss

PROJ_FACTOR = 2    # mLSTM block up-projection (paper: PF = 2)
ROWS = 1024        # query rows of the parallel form computed at once
GATES = ("z", "i", "f", "o")


def _dims(model: dict) -> tuple:
    kinds = set(model["block_pattern"])
    if not kinds <= {"mlstm", "slstm"}:
        raise ValueError("xlstm covers mlstm and slstm blocks only")
    d, h = model["d_model"], model["mlstm_heads"]
    return d, h, PROJ_FACTOR * d // h, model["vocab_size"]


def _groups(model: dict) -> int:
    return model["num_layers"] // len(model["block_pattern"])


def param_shapes(model: dict) -> dict:
    """``{path: shape}`` of one agent's parameters."""
    d, h, hd, v = _dims(model)
    di, g = h * hd, _groups(model)
    shapes = {("embed", "table"): (v, d), ("final_norm", "scale"): (d,)}
    if not model["tie_embeddings"]:
        shapes[("unembed", "table")] = (v, d)
    for i, kind in enumerate(model["block_pattern"]):
        b = ("blocks", f"b{i}_{kind}")
        shapes[b + ("norm1", "scale")] = (g, d)
        mix = b + ("mixer",)
        if kind == "mlstm":
            shapes[mix + ("up", "kernel")] = (g, d, 2 * di)
            for name in ("wq", "wk", "wv"):
                shapes[mix + (name,)] = (g, h, hd, hd)
            for name in ("wi", "wf"):
                shapes[mix + (name, "kernel")] = (g, d, h)
                shapes[mix + (name, "bias")] = (g, h)
            shapes[mix + ("down", "kernel")] = (g, di, d)
        else:
            for gate in GATES:
                shapes[mix + (f"w{gate}", "kernel")] = (g, d, d)
                shapes[mix + (f"w{gate}", "bias")] = (g, d)
            for gate in GATES:
                shapes[mix + (f"r{gate}",)] = (g, d, d)
            shapes[mix + ("out", "kernel")] = (g, d, d)
    return shapes


def init_rule(path: tuple, shape: tuple, model: dict) -> tuple:
    """``(offset, std)`` of a leaf's random draw, the xLSTM code's
    initialisation (github.com/NX-AI/xlstm, ``components/init.py`` and the
    layers' ``reset_parameters``): "small init" N(0, 2/(5d)) for the
    embedding, the mLSTM up-projection and q, k, v, and the sLSTM gates'
    input and recurrent weights; "Wang init" N(0, (2/(L·√d))²) for the
    down- and output projections; the mLSTM gates' weights zero, their
    forget bias spread 3 → 6 over the heads, input bias N(0, 0.1²); norm
    gains one. In the sLSTM the forget bias takes the same spread over its
    units (the code's block-dependent power law is not reproduced), its
    other biases zero, and the recurrent weights small init where the
    code's default is zero, so that the recurrent product is exercised.
    At a generic N/√fan_in draw q·k is some twelve times larger and the
    parallel form's read-out divides by sums of signed terms that
    rounding moves by as much as the terms (PERF.md, PR 36)."""
    d = model["d_model"]
    small = (2 / (5 * d)) ** 0.5
    wang = 2 / model["num_layers"] / d**0.5
    name = "/".join(path[3:])
    if path[-1] == "scale":
        return 1.0, 0.0
    if path[-1] == "table":
        return 0.0, small
    if name in ("down/kernel", "out/kernel"):
        return 0.0, wang
    if name in ("wi/kernel", "wf/kernel") and "mlstm" in path[1]:
        return 0.0, 0.0
    if name == "wf/bias":
        return torch.linspace(3.0, 6.0, shape[-1]).tolist(), 0.0
    if name == "wi/bias" and "mlstm" in path[1]:
        return 0.0, 0.1
    if path[-1] == "bias":
        return 0.0, 0.0
    return 0.0, small


def matmul_weights(model: dict) -> int:
    """Weights that a token meets in a product (sLSTM's recurrent ones
    included: each step multiplies h_{t−1} by them once)."""
    d, h, hd, v = _dims(model)
    di = h * hd
    per = {"mlstm": d * 2 * di + 3 * h * hd * hd + 2 * d * h + di * d,
           "slstm": 9 * d * d}
    return _groups(model) * sum(per[k] for k in model["block_pattern"]) + v * d


def flops_per_token(model: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token, forward and backward, no
    recomputation: 6 per matmul weight, and the parallel form's two
    products, 12·H·hd per live (query, key) pair of each mLSTM layer."""
    d, h, hd, v = _dims(model)
    mlstm = _groups(model) * list(model["block_pattern"]).count("mlstm")
    return 6.0 * matmul_weights(model) + 12 * h * hd * mlstm * (seq_len + 1) / 2


def _lin(mm: Matmul, x, w):
    """x ``[A, B, S, i]`` times each agent's ``w [A, i, o]``."""
    return mm(x, w[:, None])


def _mlstm(x, p: dict, model: dict, mm: Matmul):
    d, h, hd, v = _dims(model)
    a_, b_, s, _ = x.shape
    u = rmsnorm(x, p["norm1"][:, None, None], model["norm_eps"])
    xin, z = _lin(mm, u, p["up.kernel"]).chunk(2, dim=-1)
    xh = xin.reshape(a_, b_, s, h, hd).permute(0, 3, 1, 2, 4).reshape(
        a_, h, b_ * s, hd)

    def heads(w):                                      # → [A, B, H, S, hd]
        return mm(xh, w).reshape(a_, h, b_, s, hd).transpose(1, 2)

    q, k, vv = heads(p["wq"]), heads(p["wk"]) * hd**-0.5, heads(p["wv"])
    ig = (_lin(mm, u, p["wi.kernel"]) + p["wi.bias"][:, None, None]).transpose(2, 3)
    fg = (_lin(mm, u, p["wf.kernel"]) + p["wf.bias"][:, None, None]).transpose(2, 3)
    fcum = torch.cumsum(F.logsigmoid(fg), dim=-1)      # [A, B, H, S]
    ys = []
    for i0 in range(0, s, ROWS):
        i1 = min(i0 + ROWS, s)
        dm = fcum[..., i0:i1, None] - fcum[..., None, :i1] + ig[..., None, :i1]
        causal = (torch.arange(i1, device=x.device)[None, :]
                  <= torch.arange(i0, i1, device=x.device)[:, None])
        dm = dm.masked_fill(~causal, float("-inf"))
        m = dm.amax(dim=-1, keepdim=True)
        c = mm(q[..., i0:i1, :], k[..., :i1, :].transpose(-1, -2)) * torch.exp(dm - m)
        norm = torch.maximum(c.sum(dim=-1).abs(), torch.exp(-m[..., 0]))
        ys.append(mm(c, vv[..., :i1, :]) / (norm[..., None] + 1e-6))
    y = torch.cat(ys, dim=-2).transpose(2, 3).reshape(a_, b_, s, h * hd)
    return x + _lin(mm, y * F.silu(z), p["down.kernel"])


class SLSTMLoop(torch.autograd.Function):
    """h_t for t < S from the gates' input projections ``pre_x [A, B, S,
    4d]`` (z, i, f, o) and the recurrent weights ``r [A, d, 4d]``, from
    the zero state (m = −inf). The backward walks the steps in reverse."""

    @staticmethod
    def forward(ctx, pre_x, r, mm):
        a_, b_, s, d4 = pre_x.shape
        d = d4 // 4
        h = pre_x.new_zeros(a_, b_, d)
        c, n = torch.zeros_like(h), torch.zeros_like(h)
        m = torch.full_like(h, float("-inf"))
        pres = torch.empty_like(pre_x)
        hs, cs, ns, ms = (pre_x.new_empty(a_, b_, s, d) for _ in range(4))
        for t in range(s):
            pre = torch.add(pre_x[:, :, t], mm(h, r), out=pres[:, :, t])
            zt, it, ft, ot = pre.chunk(4, dim=-1)
            lfm = F.logsigmoid(ft) + m
            m = torch.maximum(lfm, it)
            iw, fw = torch.exp(it - m), torch.exp(lfm - m)
            c = fw * c + iw * torch.tanh(zt)
            n = fw * n + iw
            h = torch.sigmoid(ot) * c / torch.maximum(n, torch.exp(-m) + 1e-6)
            cs[:, :, t], ns[:, :, t], ms[:, :, t], hs[:, :, t] = c, n, m, h
        ctx.mm = mm
        ctx.save_for_backward(pres, hs, cs, ns, ms, r)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        pres, hs, cs, ns, ms, r = ctx.saved_tensors
        mm = ctx.mm
        a_, b_, s, d = hs.shape
        zt, it, ft, ot = pres.chunk(4, dim=-1)
        shift = lambda t, fill: torch.cat(                      # noqa: E731
            [torch.full_like(t[:, :, :1], fill), t[:, :, :-1]], dim=2)
        c0, n0, m0 = shift(cs, 0.0), shift(ns, 0.0), shift(ms, float("-inf"))
        # Everything that does not depend on the gradient carried back.
        z, o = torch.tanh(zt), torch.sigmoid(ot)
        lfm = F.logsigmoid(ft) + m0
        iw, fw = torch.exp(it - ms), torch.exp(lfm - ms)
        e = torch.exp(-ms) + 1e-6
        use_n = ns >= e
        den = torch.where(use_n, ns, e)
        k_gc, k_do = o / den, cs / den
        k_den = -o * cs / den**2
        k_n = torch.where(use_n, k_den, 0.0)
        k_m = torch.where(use_n, 0.0, k_den * -(e - 1e-6))
        from_f = (lfm >= it).to(hs.dtype)
        dz, do_, dlf = 1 - z * z, o * (1 - o), torch.sigmoid(-ft)
        dpre = torch.empty_like(pres)
        rt = r.transpose(1, 2)
        gh_rec = hs.new_zeros(a_, b_, d)
        gc, gn, gm = torch.zeros_like(gh_rec), torch.zeros_like(gh_rec), \
            torch.zeros_like(gh_rec)
        for t in reversed(range(s)):
            sl = (slice(None), slice(None), t)
            gh = dhs[sl] + gh_rec
            gc = gc + gh * k_gc[sl]
            gn = gn + gh * k_n[sl]
            gm = gm + gh * k_m[sl]
            gfw = gc * c0[sl] + gn * n0[sl]
            giw = gc * z[sl] + gn
            giw_iw, gfw_fw = giw * iw[sl], gfw * fw[sl]
            gm = gm - giw_iw - gfw_fw
            gm_f = gm * from_f[sl]
            out = dpre[sl]
            out[..., :d] = gc * iw[sl] * dz[sl]
            out[..., d:2 * d] = giw_iw + gm - gm_f
            out[..., 2 * d:3 * d] = (gfw_fw + gm_f) * dlf[sl]
            out[..., 3 * d:] = gh * k_do[sl] * do_[sl]
            gh_rec = mm(out, rt)
            gc, gn, gm = gc * fw[sl], gn * fw[sl], gfw_fw + gm_f
        h_prev = shift(hs, 0.0).reshape(a_, b_ * s, d)
        dr = torch.matmul(h_prev.transpose(1, 2), dpre.reshape(a_, b_ * s, 4 * d))
        return dpre, dr, None


def _slstm(x, p: dict, model: dict, mm: Matmul):
    u = rmsnorm(x, p["norm1"][:, None, None], model["norm_eps"])
    w = torch.cat([p[f"w{g}.kernel"] for g in GATES], dim=-1)
    bias = torch.cat([p[f"w{g}.bias"] for g in GATES], dim=-1)
    pre_x = _lin(mm, u, w) + bias[:, None, None]
    r = torch.cat([p[f"r{g}"] for g in GATES], dim=-1)
    return x + _lin(mm, SLSTMLoop.apply(pre_x, r, mm), p["out.kernel"])


def _block_leaves(params: dict, model: dict) -> list:
    """``[(kind, {name: [A, …] view})]`` for every layer, in order: each
    stacked leaf unbound once over its group axis."""
    per_kind = []
    for i, kind in enumerate(model["block_pattern"]):
        prefix = ("blocks", f"b{i}_{kind}")
        names = {"norm1": prefix + ("norm1", "scale")}
        for path in params:
            if path[:3] == prefix + ("mixer",):
                names[".".join(path[3:])] = path
        per_kind.append((kind, {k: params[path].unbind(1)
                                for k, path in names.items()}))
    return [(kind, {k: v[gi] for k, v in leaves.items()})
            for gi in range(_groups(model)) for kind, leaves in per_kind]


def _head_loss(x, norm, table, labels, eps, mm):
    return token_loss(mm(rmsnorm(x, norm, eps), table.T), labels)


def agent_grads(params: dict, tokens: torch.Tensor, model: dict, mm: Matmul):
    """For each agent a of the stacked ``params`` (``{path: [A, …]}``) and
    ``tokens [A, B, S + 1]``: yields ``(a, its mean loss over the B rows,
    {path: its gradient})``. All agents go through the model together."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    inputs, labels = tokens[..., :-1], tokens[..., 1:]
    table = leaves[("embed", "table")]
    agents = torch.arange(tokens.shape[0], device=tokens.device)
    x = table[agents[:, None, None], inputs]
    for kind, p in _block_leaves(leaves, model):
        if kind == "mlstm":
            x = torch.utils.checkpoint.checkpoint(
                _mlstm, x, p, model, mm, use_reentrant=False)
        else:   # the loop keeps its own states for its backward
            x = _slstm(x, p, model, mm)
    head = table if model["tie_embeddings"] else leaves[("unembed", "table")]
    losses = torch.stack([
        torch.utils.checkpoint.checkpoint(
            _head_loss, x[a], leaves[("final_norm", "scale")][a], head[a],
            labels[a], model["norm_eps"], mm, use_reentrant=False)
        for a in range(tokens.shape[0])])
    losses.sum().backward()
    for a in range(tokens.shape[0]):
        yield a, float(losses[a].detach()), {k: v.grad[a] for k, v in leaves.items()}
