"""Per-kind residual blocks with one (init / train / serve) API.

Counterpart of the JAX package's ``models/blocks.py`` for the attention
kinds, with a dense FFN (``attn``, ``swa``, ``local``, ``global``) or the
MoE FFN of ``models/moe.py`` (``attn_moe``, ``swa_moe``):

  init(generator, cfg, kind, device)            -> params
  apply_train(params, x, cfg, kind)             -> (x, aux_losses)
  init_cache(batch, max_len, cfg, kind, device) -> cache
  apply_decode(params, x, cache, cfg, kind)     -> (x, cache)   (in place)
  prefill(params, x, cfg, kind, max_len, cache) -> (x, cache)

The recurrent kinds (Mamba, ``mamba_moe``, xLSTM) raise
``NotImplementedError`` until ``models/ssm.py`` is ported (ROADMAP queue
A, "SSM blocks").
"""

from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.configs.base import MOE_KINDS, ModelConfig
from repro_torch.models import attention, layers, moe

PORTED_KINDS = ("attn", "attn_moe", "swa", "swa_moe", "local", "global")


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP queue A, "
            f"'SSM blocks'); ported kinds: {PORTED_KINDS}"
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


def _moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    return moe.MoESpec(
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        num_experts=cfg.num_experts,
        top_k=cfg.num_experts_per_token,
        capacity_factor=cfg.capacity_factor,
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
        "ffn": (
            moe.init(generator, _moe_spec(cfg), pdt, device, lead)
            if kind in MOE_KINDS
            else layers.mlp_init(
                generator, cfg.d_model, cfg.d_ff, pdt, device, lead
            )
        ),
    }


def apply_train(params, x, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    x = x + attention.apply_train(
        params["mixer"], h, _attn_spec(cfg, kind), cdt
    )
    x, aux = _ffn(params, x, cfg, kind, cdt, with_aux=True)
    return x, no_aux(x.device) if aux is None else aux


def _ffn(params, x, cfg: ModelConfig, kind: str, cdt, with_aux=False):
    """The residual FFN → (x, the router's aux losses for a MoE kind when
    ``with_aux``, else None). The serving forms drop the aux, as the
    reference's do."""
    h = layers.rmsnorm_apply(params["norm2"], x, cfg.norm_eps, cdt)
    if kind in MOE_KINDS:
        y, aux = moe.apply(params["ffn"], h, _moe_spec(cfg), cdt, with_aux)
        return x + y, aux
    return x + layers.mlp_apply(params["ffn"], h, cdt), None


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
    return _ffn(params, x + y, cfg, kind, cdt)[0], cache


def prefill(params, x, cfg: ModelConfig, kind: str, max_len: int, cache=None):
    """Full-sequence pass that also fills the decode cache (``cache`` when
    given, written in place, else a new one)."""
    _check_kind(kind)
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    y, cache = attention.prefill_cache(
        params["mixer"], h, _attn_spec(cfg, kind), cdt, max_len, cache
    )
    return _ffn(params, x + y, cfg, kind, cdt)[0], cache
