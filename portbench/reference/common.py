"""Pieces the plain references share: the matmul in the precision asked
for, RMSNorm, rotary embeddings, the token loss and the parameter tree."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to FP8_MAX); the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = FP8_MAX / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (q - x).detach()


class Matmul:
    """``a @ b`` in float32, or with both operands rounded to float8 first
    (``fp8=True``: the control, one precision below bfloat16)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [..., S, heads, hd]`` at positions 0..S-1,
    the rotated pairs being the two halves of hd (Qwen2's rotate_half)."""
    s, hd = x.shape[-3], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every position."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).to(torch.int64))


def nest(flat: dict) -> dict:
    """``{(k1, k2, …): leaf}`` → the nested dict ``{k1: {k2: … leaf}}``."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    """The nested dict ``tree`` → ``{(k1, k2, …): leaf}``."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out
