"""The unified decoder model: embed → loop over block groups → LM head.

Counterpart of the JAX package's ``models/model.py``. Functional API:

  init(cfg, generator, device)            -> params
  forward(cfg, params, inputs)            -> (logits [B, S, V], aux)
  loss(cfg, params, batch)                -> (scalar, metrics)
  init_caches(cfg, batch, max_len, device) -> caches
  prefill(cfg, params, inputs, max_len)   -> (last_logits [B, 1, V], caches)
  decode_step(cfg, params, caches, token) -> (logits [B, 1, V], caches)
  parameter_count(cfg, params=None)       -> int

``inputs`` is a dict: {"tokens": [B, S]} for LMs; the VLM backbone
(``frontend="vision_patches"``) adds {"patch_embeds": [B, P, D]}, which
``patch_proj`` projects and puts before the tokens, and the audio backbone
(``"audio_codec"``) takes codec token ids as tokens. Parameters and caches
keep the reference's stacked-group layout — ``params["blocks"]["b0_attn"]``
leaves and ``caches["b0_attn"]["k"|"v"|"pos"]`` (or a recurrent block's
state, ``caches["b0_mamba"]["conv"|"ssm"]``) carry a leading G axis — so
the two packages' trees map key for key (``models/convert.py``); the
groups are walked with a Python loop. ``decode_step`` writes the caches in
place and returns the same dict (the reference returns new arrays).

Under tensor parallelism (``sharding_hints.tp()``, the rank's local
leaves) the vocabulary is split: the embedding looks up its local rows
with the other ids masked and sums over the ranks; ``loss`` is a
vocabulary-parallel cross-entropy on the local logits (the max, the sum
of exponentials and the label's logit summed over the ranks, never the
whole ``[B, S, V]``); ``forward``, ``prefill`` and ``decode_step`` return
the whole logits, gathered once over the vocabulary. Under FSDP
(``sharding_hints.dp()``) each group's leaves are gathered whole over
"data" as the group starts (inside the recomputed region, so backward
gathers them again and reduce-scatters their gradients), and the
embedding tables and ``patch_proj`` where they are used.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch import compat
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, layers
from repro_torch.models import sharding_hints as sh
from repro_torch.models.sharding_hints import constrain
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _generator(generator, device: torch.device):
    if device.type == "meta":
        return None
    if isinstance(generator, int):
        return torch.Generator(device=device).manual_seed(generator)
    if not isinstance(generator, torch.Generator):
        raise TypeError(
            "init needs an explicit torch.Generator (or an integer seed); "
            "the port draws nothing from the global RNG"
        )
    if generator.device.type != device.type:
        raise ValueError(
            f"generator lives on {generator.device}, parameters are "
            f"initialised on {device}"
        )
    return generator


def init(
    cfg: ModelConfig,
    generator: torch.Generator | int,
    device: str | torch.device | None = None,
) -> dict:
    """Random parameters drawn from ``generator`` on ``device`` (``None``
    means CUDA). The bits differ from the JAX package's ``init`` for any
    seed: parity goes through ``models.convert.params_from_jax``."""
    dev = (
        torch.device("meta") if str(device) == "meta"
        else compat.resolve_device(device)
    )
    gen = _generator(generator, dev)
    pdt = compat.dtype_of(cfg.param_dtype)
    params: dict = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, pdt, dev),
        "final_norm": layers.rmsnorm_init(cfg.d_model, pdt, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.embed_init(
            gen, cfg.vocab_size, cfg.d_model, pdt, dev
        )
    if cfg.frontend == "vision_patches":
        params["patch_proj"] = layers.dense_init(
            gen, cfg.d_model, cfg.d_model, pdt, dev
        )
    # Stacked per-group block params: every leaf has a leading G axis.
    g = cfg.num_groups
    params["blocks"] = {
        f"b{i}_{kind}": blocks.init(gen, cfg, kind, dev, lead=(g,))
        for i, kind in enumerate(cfg.block_pattern)
    }
    return params


def _embed_tokens(cfg: ModelConfig, params, tokens) -> torch.Tensor:
    cdt = compat.dtype_of(cfg.compute_dtype)
    embed = sh.gather_fsdp(params["embed"], "embed")
    table = embed["table"]
    v0, v1, partial = sh.local_range(table.shape[0], cfg.vocab_size)
    if partial:
        ids = tokens.to(torch.int64)
        inside = (ids >= v0) & (ids < v1)
        x = table.to(cdt)[torch.where(inside, ids - v0, 0)]
        x = sh.reduce_from_tp(torch.where(inside[..., None], x, 0))
    else:
        x = layers.embed_apply(embed, tokens, cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cdt, device=x.device)
    return x


def _embed_inputs(cfg: ModelConfig, params, inputs) -> torch.Tensor:
    """Token embeddings, after the projected patches for the VLM."""
    x = _embed_tokens(cfg, params, inputs["tokens"])
    if cfg.frontend == "vision_patches":
        cdt = compat.dtype_of(cfg.compute_dtype)
        d = cfg.d_model
        kernel = sh.gather_fsdp(params["patch_proj"], "patch_proj")["kernel"]
        proj = {"kernel": sh.take(kernel, -1, 0, d, d, False,
                                  "frontend/patch_proj")}
        patches = layers.dense_apply(
            proj, inputs["patch_embeds"].to(cdt), cdt
        )
        x = torch.cat([patches, x], dim=1)
    return x


def _group_params(cfg: ModelConfig, params) -> list[dict]:
    """The block parameters of each group, as views. One unbind per
    stacked leaf (its backward is one stack), not one select per group
    (whose backward would zero-fill the whole leaf once per group)."""
    unbound = [p.unbind(0) for p in tree_leaves(params["blocks"])]
    return [
        tree_unflatten(params["blocks"], [u[gi] for u in unbound])
        for gi in range(cfg.num_groups)
    ]


def _loop_groups(cfg: ModelConfig, params, x, remat: bool = True):
    pattern = cfg.block_pattern

    def group_body(x, gp):
        # Group boundaries are batch-pinned only, as in the reference.
        x = constrain(x, ("batch", None, None))
        # FSDP: the group's leaves whole over "data" (gathered again by
        # the recompute, freed after the group)
        gp = sh.gather_fsdp(gp, "blocks", lead=1)
        aux_tot = blocks.no_aux(x.device)
        for i, kind in enumerate(pattern):
            x, aux = blocks.apply_train(gp[f"b{i}_{kind}"], x, cfg, kind)
            aux_tot = {k: aux_tot[k] + aux[k] for k in aux_tot}
        return x, aux_tot

    aux = blocks.no_aux(x.device)
    for gp in _group_params(cfg, params):
        if remat and torch.is_grad_enabled():
            # the recompute may run on autograd's thread: carry the hints
            x, aux_g = torch.utils.checkpoint.checkpoint(
                sh.carry(group_body), x, gp, use_reentrant=False
            )
        else:
            x, aux_g = group_body(x, gp)
        aux = {k: aux[k] + aux_g[k] for k in aux}
    return x, aux


def _local_logits(cfg: ModelConfig, params, x):
    """Final norm, LM head, float32 logits with the final softcap → (the
    logits, whether they are this rank's block of the vocabulary)."""
    cdt = compat.dtype_of(cfg.compute_dtype)
    x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps, cdt)
    name = "embed" if cfg.tie_embeddings else "unembed"
    table = sh.gather_fsdp(params[name], name)
    partial = sh.local_range(table["table"].shape[0], cfg.vocab_size)[2]
    if partial:
        x = sh.copy_to_tp(x)
    logits = layers.unembed_apply(table, x, cdt)
    return layers.softcap(logits.to(torch.float32),
                          cfg.final_logit_softcap), partial


def _logits(cfg: ModelConfig, params, x) -> torch.Tensor:
    """The whole vocabulary's logits (gathered under tensor parallelism)."""
    logits, partial = _local_logits(cfg, params, x)
    return sh.gather_from_tp(logits, -1) if partial else logits


def forward(cfg: ModelConfig, params, inputs, remat: bool = True):
    """Training/scoring forward pass → (logits, aux_losses)."""
    x = _embed_inputs(cfg, params, inputs)
    x, aux = _loop_groups(cfg, params, x, remat=remat)
    return _logits(cfg, params, x), aux


def _nll(lg: torch.Tensor, labels: torch.Tensor,
         partial: bool = False) -> torch.Tensor:
    """lse − label_logit over the vocab dim of float32 logits, as the
    reference computes it (the max is a constant of the differentiation
    there too); vocabulary-parallel on a rank's block of the logits."""
    m = lg.max(dim=-1, keepdim=True).values.detach()
    if not partial:
        lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
        label_logit = lg.gather(-1, labels[..., None])[..., 0]
        return lse - label_logit
    m = sh.reduce_max_from_tp(m)
    v0 = sh.tp().index * lg.shape[-1]
    inside = (labels >= v0) & (labels < v0 + lg.shape[-1])
    mine = lg.gather(-1, torch.where(inside, labels - v0, 0)[..., None])
    label_logit = sh.reduce_from_tp(torch.where(inside, mine[..., 0], 0.0))
    sumexp = sh.reduce_from_tp(torch.exp(lg - m).sum(dim=-1))
    return torch.log(sumexp) + m[..., 0] - label_logit


def loss(
    cfg: ModelConfig,
    params,
    batch,
    moe_aux_weight: float = 1e-2,
    router_z_weight: float = 1e-3,
    remat: bool = True,
):
    """Next-token cross-entropy. batch: {"tokens": [B, S+1], ...}.

    For the VLM backbone, patch positions are prepended by the model and
    excluded from the loss (labels cover text tokens only).
    """
    tokens = batch["tokens"]
    inputs = dict(batch)
    inputs["tokens"] = tokens[:, :-1]
    labels = tokens[:, 1:].to(torch.int64)

    x = _embed_inputs(cfg, params, inputs)
    x, aux = _loop_groups(cfg, params, x, remat=remat)
    logits, partial = _local_logits(cfg, params, x)
    if cfg.frontend == "vision_patches":
        logits = logits[:, inputs["patch_embeds"].shape[1]:, :]

    nll = _nll(logits.to(torch.float32), labels, partial)
    ce = nll.mean()
    total = (
        ce
        + moe_aux_weight * aux["load_balance_loss"]
        + router_z_weight * aux["router_z_loss"]
    )
    metrics = {"ce": ce, **aux}
    return total, metrics


def init_caches(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    device: str | torch.device | None = None,
    params=None,
) -> dict:
    """Stacked decode caches, empty: ``{"b{i}_{kind}": {"k", "v": [G, B,
    S_cache, KV, Dh], "pos": int32 [G]}}`` for attention kinds, the mixer's
    state with a leading G for recurrent ones (zeros, ``m`` at −inf), on
    ``device`` (``None`` means CUDA; ``"meta"`` gives shapes only). Under
    tensor parallelism, with the rank's local ``params``, at its local
    widths (its KV heads, its block of Mamba's d_inner)."""
    dev = (
        torch.device("meta") if str(device) == "meta"
        else compat.resolve_device(device)
    )
    return {
        f"b{i}_{kind}": blocks.init_cache(
            batch, max_len, cfg, kind, dev, lead=(cfg.num_groups,),
            params=None if params is None else params["blocks"][
                f"b{i}_{kind}"],
        )
        for i, kind in enumerate(cfg.block_pattern)
    }


def _group_caches(caches: dict, gi: int) -> dict:
    """Group ``gi``'s caches as views: writes to them land in ``caches``."""
    return tree_map(lambda t: t[gi], caches)


def prefill(cfg: ModelConfig, params, inputs, max_len: int):
    """Process the prompt → (logits at the last position ``[B, 1, V]``,
    caches of depth ``max_len`` holding the prompt)."""
    x = _embed_inputs(cfg, params, inputs)
    caches = init_caches(cfg, x.shape[0], max_len, x.device, params)
    for gi, gp in enumerate(_group_params(cfg, params)):
        gp = sh.gather_fsdp(gp, "blocks", lead=1)
        gc = _group_caches(caches, gi)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"b{i}_{kind}"
            x, _ = blocks.prefill(gp[key], x, cfg, kind, max_len, gc[key])
    return _logits(cfg, params, x[:, -1:, :]), caches


def decode_step(cfg: ModelConfig, params, caches, token):
    """One decode step. token: ``[B, 1]`` int → (logits ``[B, 1, V]``,
    caches). The caches are written in place and returned; nothing is
    read back to the host."""
    x = _embed_tokens(cfg, params, token)
    for gi, gp in enumerate(_group_params(cfg, params)):
        gp = sh.gather_fsdp(gp, "blocks", lead=1)
        gc = _group_caches(caches, gi)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"b{i}_{kind}"
            x, _ = blocks.apply_decode(gp[key], x, gc[key], cfg, kind)
    return _logits(cfg, params, x), caches


def parameter_count(cfg: ModelConfig, params=None) -> int:
    if params is None:
        params = init(cfg, 0, device="meta")
    return sum(math.prod(l.shape) for l in tree_leaves(params))
