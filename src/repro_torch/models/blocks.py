"""Per-kind residual blocks with one (init / train / serve) API.

Counterpart of the JAX package's ``models/blocks.py`` for the attention
kinds with a dense FFN (``attn``, ``swa``, ``local``, ``global``):

  init(generator, cfg, kind, device)            -> params
  apply_train(params, x, cfg, kind)             -> (x, aux_losses)
  init_cache(batch, max_len, cfg, kind, device) -> cache
  apply_decode(params, x, cache, cfg, kind)     -> (x, cache)   (in place)
  prefill(params, x, cfg, kind, max_len, cache) -> (x, cache)

The MoE kinds and the recurrent kinds (Mamba, xLSTM) raise
``NotImplementedError`` until their modules are ported (ROADMAP queue A,
"MoE/SSM blocks").
"""

from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers

PORTED_KINDS = ("attn", "swa", "local", "global")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP queue A, "
            f"'MoE/SSM blocks'); ported kinds: {PORTED_KINDS}"
        )


def _attn_spec(cfg: ModelConfig, kind: str) -> attention.AttnSpec:
    window = None
    if kind in ("swa", "swa_moe", "local"):
        window = cfg.sliding_window
    return attention.AttnSpec(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        window=window,
        rope_theta=cfg.rope_theta,
        softcap=cfg.attn_logit_softcap,
        qkv_bias=cfg.qkv_bias,
    )


def _dtype(cfg: ModelConfig):
    return compat.dtype_of(cfg.param_dtype), compat.dtype_of(cfg.compute_dtype)


def no_aux(device) -> dict:
    return {
        "load_balance_loss": torch.zeros((), dtype=torch.float32, device=device),
        "router_z_loss": torch.zeros((), dtype=torch.float32, device=device),
    }


def init(generator, cfg: ModelConfig, kind: str, device, lead=()) -> dict:
    _check_kind(kind)
    pdt, _ = _dtype(cfg)
    return {
        "norm1": layers.rmsnorm_init(cfg.d_model, pdt, device, lead),
        "mixer": attention.init(
            generator, _attn_spec(cfg, kind), pdt, device, lead
        ),
        "norm2": layers.rmsnorm_init(cfg.d_model, pdt, device, lead),
        "ffn": layers.mlp_init(
            generator, cfg.d_model, cfg.d_ff, pdt, device, lead
        ),
    }


def apply_train(params, x, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    x = x + attention.apply_train(
        params["mixer"], h, _attn_spec(cfg, kind), cdt
    )
    return _ffn(params, x, cfg, cdt), no_aux(x.device)


def _ffn(params, x, cfg: ModelConfig, cdt):
    h = layers.rmsnorm_apply(params["norm2"], x, cfg.norm_eps, cdt)
    return x + layers.mlp_apply(params["ffn"], h, cdt)


def init_cache(batch: int, max_len: int, cfg: ModelConfig, kind: str, device):
    _check_kind(kind)
    _, cdt = _dtype(cfg)
    return attention.init_cache(
        batch, max_len, _attn_spec(cfg, kind), cdt, device
    )


def apply_decode(params, x, cache, cfg: ModelConfig, kind: str):
    """One token through the block; ``cache`` is updated in place."""
    _check_kind(kind)
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    y, cache = attention.apply_decode(
        params["mixer"], h, cache, _attn_spec(cfg, kind), cdt
    )
    return _ffn(params, x + y, cfg, cdt), cache


def prefill(params, x, cfg: ModelConfig, kind: str, max_len: int, cache=None):
    """Full-sequence pass that also fills the decode cache (``cache`` when
    given, written in place, else a new one)."""
    _check_kind(kind)
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    y, cache = attention.prefill_cache(
        params["mixer"], h, _attn_spec(cfg, kind), cdt, max_len, cache
    )
    return _ffn(params, x + y, cfg, cdt), cache
