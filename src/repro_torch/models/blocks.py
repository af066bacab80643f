"""Per-kind residual blocks with one (init / train / serve) API.

Counterpart of the JAX package's ``models/blocks.py``, every kind: the
attention kinds with a dense FFN (``attn``, ``swa``, ``local``,
``global``) or the MoE FFN of ``models/moe.py`` (``attn_moe``,
``swa_moe``); the Mamba mixer of ``models/ssm.py`` with a dense FFN
(``mamba``) or the MoE FFN (``mamba_moe``); and xLSTM's ``mlstm`` and
``slstm``, which have no FFN and no ``norm2``:

  init(generator, cfg, kind, device)            -> params
  apply_train(params, x, cfg, kind)             -> (x, aux_losses)
  init_cache(batch, max_len, cfg, kind, device) -> cache
  apply_decode(params, x, cache, cfg, kind)     -> (x, cache)   (in place)
  prefill(params, x, cfg, kind, max_len, cache) -> (x, cache)

A recurrent kind's cache is its mixer's state (``conv``, ``ssm``; ``c``,
``n``, ``m``; ``c``, ``n``, ``h``, ``m``), written in place by
``apply_decode`` and ``prefill`` as the attention caches are.
"""

from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.configs.base import ATTN_KINDS, MOE_KINDS, ModelConfig
from repro_torch.models import attention, layers, moe, ssm


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


def _mamba_spec(cfg: ModelConfig) -> ssm.MambaSpec:
    return ssm.MambaSpec(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state_dim,
        d_conv=cfg.ssm_conv_dim,
        expand=cfg.ssm_expand,
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


def _has_ffn(kind: str) -> bool:
    return kind not in ("mlstm", "slstm")


def _recurrent(cfg: ModelConfig, kind: str):
    """(the ``ssm`` mixer's name, its spec) of a recurrent kind."""
    if kind in ("mamba", "mamba_moe"):
        return "mamba", _mamba_spec(cfg)
    if kind == "mlstm":
        return "mlstm", ssm.MLSTMSpec(cfg.d_model, cfg.mlstm_heads)
    if kind == "slstm":
        return "slstm", ssm.SLSTMSpec(cfg.d_model, cfg.mlstm_heads)
    raise ValueError(kind)


def _mixer_fn(cfg: ModelConfig, kind: str, form: str):
    """``ssm.<mixer>_<form>`` of a recurrent kind, and its spec."""
    name, spec = _recurrent(cfg, kind)
    return getattr(ssm, f"{name}_{form}"), spec


def no_aux(device) -> dict:
    return {
        "load_balance_loss": torch.zeros((), dtype=torch.float32, device=device),
        "router_z_loss": torch.zeros((), dtype=torch.float32, device=device),
    }


def init(generator, cfg: ModelConfig, kind: str, device, lead=()) -> dict:
    pdt, _ = _dtype(cfg)
    p: dict = {"norm1": layers.rmsnorm_init(cfg.d_model, pdt, device, lead)}
    if kind in ATTN_KINDS:
        p["mixer"] = attention.init(
            generator, _attn_spec(cfg, kind), pdt, device, lead)
    else:
        fn, spec = _mixer_fn(cfg, kind, "init")
        p["mixer"] = fn(generator, spec, pdt, device, lead)
    if _has_ffn(kind):
        p["norm2"] = layers.rmsnorm_init(cfg.d_model, pdt, device, lead)
        p["ffn"] = (
            moe.init(generator, _moe_spec(cfg), pdt, device, lead)
            if kind in MOE_KINDS
            else layers.mlp_init(
                generator, cfg.d_model, cfg.d_ff, pdt, device, lead
            )
        )
    return p


def apply_train(params, x, cfg: ModelConfig, kind: str):
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    if kind in ATTN_KINDS:
        y = attention.apply_train(
            params["mixer"], h, _attn_spec(cfg, kind), cdt)
    else:
        fn, spec = _mixer_fn(cfg, kind, "apply_train")
        y = fn(params["mixer"], h, spec, cdt)
    x, aux = _ffn(params, x + y, cfg, kind, cdt, with_aux=True)
    return x, no_aux(x.device) if aux is None else aux


def _ffn(params, x, cfg: ModelConfig, kind: str, cdt, with_aux=False):
    """The residual FFN → (x, the router's aux losses for a MoE kind when
    ``with_aux``, else None). The serving forms drop the aux, as the
    reference's do. xLSTM kinds have none: x passes through."""
    if not _has_ffn(kind):
        return x, None
    h = layers.rmsnorm_apply(params["norm2"], x, cfg.norm_eps, cdt)
    if kind in MOE_KINDS:
        y, aux = moe.apply(params["ffn"], h, _moe_spec(cfg), cdt, with_aux)
        return x + y, aux
    return x + layers.mlp_apply(params["ffn"], h, cdt, cfg.d_ff), None


def init_cache(batch: int, max_len: int, cfg: ModelConfig, kind: str, device,
               lead=(), params=None):
    """The block's empty cache; at this rank's local widths under tensor
    parallelism when the block's local ``params`` are given."""
    _, cdt = _dtype(cfg)
    mixer = None if params is None else params["mixer"]
    if kind in ATTN_KINDS:
        return attention.init_cache(
            batch, max_len, _attn_spec(cfg, kind), cdt, device, lead, mixer)
    name, spec = _recurrent(cfg, kind)
    if name == "mamba":
        return ssm.mamba_init_state(batch, spec, cdt, device, lead, mixer)
    return getattr(ssm, f"{name}_init_state")(batch, spec, device, lead)


def _write_state(cache: dict, state: dict) -> dict:
    """A recurrent mixer's new state into its cache tensors, in place."""
    for key, t in state.items():
        cache[key].copy_(t)
    return cache


def apply_decode(params, x, cache, cfg: ModelConfig, kind: str):
    """One token through the block; ``cache`` is updated in place."""
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    if kind in ATTN_KINDS:
        y, cache = attention.apply_decode(
            params["mixer"], h, cache, _attn_spec(cfg, kind), cdt
        )
    else:
        fn, spec = _mixer_fn(cfg, kind, "apply_decode")
        y, state = fn(params["mixer"], h, cache, spec, cdt)
        cache = _write_state(cache, state)
    return _ffn(params, x + y, cfg, kind, cdt)[0], cache


def prefill(params, x, cfg: ModelConfig, kind: str, max_len: int, cache=None):
    """Full-sequence pass that also fills the decode cache (``cache`` when
    given, written in place, else a new one). A recurrent kind's state is
    the one its mixer's train form ends in (``ssm.*_prefill``), not S
    decode steps over the prompt as in the reference; the two agree to
    float32 rounding (tests/test_torch_ssm.py holds them)."""
    _, cdt = _dtype(cfg)
    h = layers.rmsnorm_apply(params["norm1"], x, cfg.norm_eps, cdt)
    if kind in ATTN_KINDS:
        y, cache = attention.prefill_cache(
            params["mixer"], h, _attn_spec(cfg, kind), cdt, max_len, cache
        )
    else:
        fn, spec = _mixer_fn(cfg, kind, "prefill")
        y, state = fn(params["mixer"], h, spec, cdt)
        if cache is None:
            cache = init_cache(x.shape[0], max_len, cfg, kind, x.device,
                               params=params)
        cache = _write_state(cache, state)
    return _ffn(params, x + y, cfg, kind, cdt)[0], cache
