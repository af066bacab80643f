"""Plain float32 reference of a dense decoder LM of Qwen2's kind.

From the published description (Qwen2 technical report, arXiv:2407.10671;
``Qwen/Qwen2-0.5B``'s config.json): token embedding; per layer a pre-norm
block of grouped-query causal attention, with bias on q, k and v and
rotary embeddings (rotate_half form, base ``rope_theta``), then a pre-norm
SwiGLU MLP; a final RMSNorm and the LM head, tied to the embedding; the
mean next-token cross-entropy. Every product and softmax is float32.

The parameter tree is the program's checkpoint layout (``param_shapes``),
the layers' leaves stacked on a leading axis, kernels stored ``[in,
out]``. Agents are taken one at a time and their rows one at a time, each
layer recomputed in the backward pass, so that one row's float32
activations are all that lives beside the parameters.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from portbench.reference.common import Matmul, rmsnorm, rope, token_loss

BLOCK = ("blocks", "b0_attn")


def _dims(model: dict) -> tuple:
    if tuple(model["block_pattern"]) != ("attn",):
        raise ValueError("dense_lm covers the block pattern ('attn',) only")
    for key in ("sliding_window", "attn_logit_softcap", "final_logit_softcap",
                "frontend"):
        if model.get(key) is not None:
            raise ValueError(f"dense_lm does not implement {key}")
    if model.get("embed_scale") or model.get("num_experts"):
        raise ValueError("dense_lm has no embedding scale and no experts")
    d, h, kv = model["d_model"], model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // h
    return d, h, kv, hd, model["d_ff"], model["vocab_size"], model["num_layers"]


def param_shapes(model: dict) -> dict:
    """``{path: shape}`` of one agent's parameters."""
    d, h, kv, hd, f, v, n = _dims(model)
    shapes = {("embed", "table"): (v, d), ("final_norm", "scale"): (d,)}
    if not model["tie_embeddings"]:
        shapes[("unembed", "table")] = (v, d)
    mix = BLOCK + ("mixer",)
    shapes[BLOCK + ("norm1", "scale")] = (n, d)
    for name, out in (("wq", h * hd), ("wk", kv * hd), ("wv", kv * hd)):
        shapes[mix + (name, "kernel")] = (n, d, out)
        if model["qkv_bias"]:
            shapes[mix + (name, "bias")] = (n, out)
    shapes[mix + ("wo", "kernel")] = (n, h * hd, d)
    shapes[BLOCK + ("norm2", "scale")] = (n, d)
    for name, shape in (("gate", (n, d, f)), ("up", (n, d, f)),
                        ("down", (n, f, d))):
        shapes[BLOCK + ("ffn", name, "kernel")] = shape
    return shapes


def init_rule(path: tuple, shape: tuple, model: dict) -> tuple:
    """``(offset, std)`` of a leaf's random draw: norm gains 1 + 0.1·N,
    biases 0.1·N, the embedding N/√d, every kernel N/√fan_in."""
    if path[-1] == "scale":
        return 1.0, 0.1
    if path[-1] == "bias":
        return 0.0, 0.1
    if path[-1] == "table":
        return 0.0, shape[-1] ** -0.5
    return 0.0, shape[-2] ** -0.5


def matmul_weights(model: dict) -> int:
    """Weights that a token meets in a product: every kernel and the head
    (the tied table counted once, as the head)."""
    d, h, kv, hd, f, v, n = _dims(model)
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    return n * per_layer + v * d


def flops_per_token(model: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token, forward and backward, no
    recomputation: 6 per matmul weight, and 12·H·hd per live causal
    (query, key) pair of each layer — (S + 1) / 2 keys for the mean
    query."""
    d, h, kv, hd, f, v, n = _dims(model)
    attn = 12 * h * hd * n * (seq_len + 1) / 2
    return 6.0 * matmul_weights(model) + attn


def _layer(x, p: dict, model: dict, mm: Matmul):
    d, h, kv, hd, f, v, n = _dims(model)
    s = x.shape[0]
    eps = model["norm_eps"]

    def proj(y, name):
        out = mm(y, p[name + ".kernel"])
        return out + p[name + ".bias"] if name + ".bias" in p else out

    a = rmsnorm(x, p["norm1"], eps)
    q = rope(proj(a, "wq").reshape(s, h, hd), model["rope_theta"])
    k = rope(proj(a, "wk").reshape(s, kv, hd), model["rope_theta"])
    vv = proj(a, "wv").reshape(s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=1)          # query head j → kv j // g
    vv = vv.repeat_interleave(h // kv, dim=1)
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0)) * hd**-0.5  # [h,s,s]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    att = mm(probs, vv.transpose(0, 1)).transpose(0, 1).reshape(s, h * hd)
    x = x + mm(att, p["wo.kernel"])
    b = rmsnorm(x, p["norm2"], eps)
    gate = mm(b, p["gate"])
    return x + mm(torch.nn.functional.silu(gate) * mm(b, p["up"]), p["down"])


def _layer_leaves(params: dict) -> list[dict]:
    """Each layer's leaves, as views of the stacked ones (one unbind a
    leaf, so the backward stacks once)."""
    names = {
        "norm1": BLOCK + ("norm1", "scale"), "norm2": BLOCK + ("norm2", "scale"),
        "wo.kernel": BLOCK + ("mixer", "wo", "kernel"),
        "gate": BLOCK + ("ffn", "gate", "kernel"),
        "up": BLOCK + ("ffn", "up", "kernel"),
        "down": BLOCK + ("ffn", "down", "kernel"),
    }
    for w in ("wq", "wk", "wv"):
        for part in ("kernel", "bias"):
            if BLOCK + ("mixer", w, part) in params:
                names[f"{w}.{part}"] = BLOCK + ("mixer", w, part)
    unbound = {k: params[path].unbind(0) for k, path in names.items()}
    n = len(next(iter(unbound.values())))
    return [{k: u[i] for k, u in unbound.items()} for i in range(n)]


def _head_loss(x, norm, table, labels, eps, mm):
    return token_loss(mm(rmsnorm(x, norm, eps), table.T), labels)


def row_loss(params: dict, tokens: torch.Tensor, model: dict,
             mm: Matmul) -> torch.Tensor:
    """Mean next-token loss of one row ``tokens [S + 1]`` under one agent's
    ``params`` (``{path: leaf}``), each layer recomputed in backward."""
    inputs, labels = tokens[:-1], tokens[1:]
    x = params[("embed", "table")][inputs]
    for p in _layer_leaves(params):
        x = torch.utils.checkpoint.checkpoint(
            _layer, x, p, model, mm, use_reentrant=False)
    table = params[("embed", "table")] if model["tie_embeddings"] else \
        params[("unembed", "table")]
    return torch.utils.checkpoint.checkpoint(
        _head_loss, x, params[("final_norm", "scale")], table, labels,
        model["norm_eps"], mm, use_reentrant=False)


def agent_grads(params: dict, tokens: torch.Tensor, model: dict, mm: Matmul):
    """For each agent a of the stacked ``params`` (``{path: [A, …]}``) and
    ``tokens [A, B, S + 1]``: yields ``(a, its mean loss over the B rows,
    {path: its gradient})``, one agent after another."""
    agents, rows = tokens.shape[:2]
    for a in range(agents):
        mine = {k: v[a].detach().requires_grad_(True) for k, v in params.items()}
        total = 0.0
        for r in range(rows):
            loss = row_loss(mine, tokens[a, r], model, mm) / rows
            loss.backward()
            total += float(loss.detach())
        yield a, total, {k: v.grad for k, v in mine.items()}
        del mine
