"""Port `models/` against the JAX package at the smoke size (fp32, CPU):
parameters cross through `convert.params_from_jax`, the same tokens go
through both, logits and loss agree."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jax_gemma
from repro.configs import jamba_1_5_large_398b as jax_jamba
from repro.configs import llava_next_34b as jax_llava
from repro.configs import mistral_large_123b as jax_mistral_large
from repro.configs import mixtral_8x7b as jax_mixtral
from repro.configs import mixtral_8x22b as jax_mixtral_22b
from repro.configs import musicgen_large as jax_musicgen
from repro.configs import qwen1_5_0_5b as jax_qwen15
from repro.configs import qwen2_0_5b as jax_cfg
from repro.configs import xlstm_125m as jax_xlstm
from repro.models import blocks as jax_blocks
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs import base as torch_base
from repro_torch.configs import gemma2_2b as torch_gemma
from repro_torch.configs import jamba_1_5_large_398b as torch_jamba
from repro_torch.configs import llava_next_34b as torch_llava
from repro_torch.configs import mistral_large_123b as torch_mistral_large
from repro_torch.configs import mixtral_8x7b as torch_mixtral
from repro_torch.configs import mixtral_8x22b as torch_mixtral_22b
from repro_torch.configs import musicgen_large as torch_musicgen
from repro_torch.configs import qwen1_5_0_5b as torch_qwen15
from repro_torch.configs import qwen2_0_5b as torch_cfg
from repro_torch.configs import xlstm_125m as torch_xlstm
from repro_torch.models import attention, blocks, convert, layers, model
from repro_torch.tree import tree_leaves, tree_paths

from _torch_parity import JCFG, TCFG, smoke_params

TOL = 1e-4  # rtol = atol, fp32 on the CPU: sums in another order only


def _tokens(seed, b=2, s=17):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_jax(seed):
    jp, tp = smoke_params(seed)
    tok = _tokens(seed)[:, :-1]
    exp, _ = jax_model.forward(JCFG, jp, {"tokens": jnp.asarray(tok)})
    got, aux = model.forward(TCFG, tp, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and got.shape == (2, 16, JCFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL, atol=TOL)
    assert float(aux["load_balance_loss"]) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jp, tp = smoke_params(0)
    tok = _tokens(3)
    jl, jg = jax.value_and_grad(
        lambda p: jax_model.loss(JCFG, p, {"tokens": jnp.asarray(tok)},
                                 remat=remat)[0]
    )(jp)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tl, metrics = model.loss(
        TCFG, tp, {"tokens": torch.from_numpy(tok)}, remat=remat
    )
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL, atol=TOL)
    assert float(metrics["ce"].detach()) == float(tl.detach())
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    for (path, _), g in zip(tree_paths(tp), grads):
        np.testing.assert_allclose(
            g.numpy(), jgrads[path], rtol=TOL, atol=TOL, err_msg=path
        )


@pytest.mark.parametrize("as_bits", [False, True])
def test_convert_round_trip(as_bits):
    """fp32 tree → port → numpy is exact; a bf16 tree crosses as float32
    or as uint16 bits and comes back bit for bit."""
    jp, tp = smoke_params(0)
    back = convert.params_to_jax(tp)
    for (path, a), (_, b) in zip(
        tree_paths(jax.tree.map(np.asarray, jp)), tree_paths(back)
    ):
        assert np.array_equal(a, b), path
    import dataclasses

    cfg16 = dataclasses.replace(TCFG, param_dtype="bfloat16")
    tree16 = jax.tree.map(
        lambda p: np.asarray(p.astype(jnp.bfloat16)), jp
    )  # ml_dtypes bfloat16 arrays
    if as_bits:
        tree16 = jax.tree.map(lambda a: a.view(np.uint16), tree16)
    else:
        tree16 = jax.tree.map(lambda a: a.astype(np.float32), tree16)
    tp16 = convert.params_from_jax(tree16, cfg16, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(tp16))
    back16 = convert.params_to_jax(tp16, bf16_as_bits=as_bits)
    for (path, a), (_, b) in zip(tree_paths(tree16), tree_paths(back16)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_convert_rejects_wrong_tree():
    jp, _ = smoke_params(0)
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"]["table"] = tree["embed"]["table"][:-1]
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(tree, TCFG, "cpu")
    del tree["embed"]
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_jax(tree, TCFG, "cpu")


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_parameter_count_equal(which):
    """By shapes only: nothing of the full config is allocated."""
    jc = JCFG if which == "smoke" else jax_cfg.CONFIG
    tc = TCFG if which == "smoke" else torch_cfg.CONFIG
    assert model.parameter_count(tc) == jax_model.parameter_count(jc)
    shapes = {k: tuple(v.shape) for k, v in
              tree_paths(model.init(tc, 0, device="meta"))}
    jshapes = {
        k: tuple(v.shape) for k, v in tree_paths(
            jax.eval_shape(lambda k: jax_model.init(jc, k), jax.random.key(0))
        )
    }
    assert shapes == jshapes


# (JAX config module, the port's own copy) of the configurations whose block
# kinds or frontends the MoE and the recurrent slices complete.
NEW_CONFIG_COPIES = (
    (jax_mixtral, torch_mixtral),
    (jax_mixtral_22b, torch_mixtral_22b),
    (jax_qwen15, torch_qwen15),
    (jax_mistral_large, torch_mistral_large),
    (jax_jamba, torch_jamba),
    (jax_xlstm, torch_xlstm),
    (jax_llava, torch_llava),
    (jax_musicgen, torch_musicgen),
)


def test_configs_are_own_equal_copies():
    import dataclasses

    assert dataclasses.asdict(torch_cfg.CONFIG) == dataclasses.asdict(
        jax_cfg.CONFIG
    )
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    assert torch_base.get_config("qwen2-0.5b") is torch_cfg.CONFIG
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(torch_gemma, name)) == (
            dataclasses.asdict(getattr(jax_gemma, name))
        )
    assert torch_base.get_config("gemma2-2b", smoke=True) is (
        torch_gemma.SMOKE_CONFIG
    )
    assert dataclasses.asdict(torch_base.get_train_config("gemma2-2b")) == (
        dataclasses.asdict(jax_gemma.TRAIN_CONFIG)
    )
    for jmod, tmod in NEW_CONFIG_COPIES:
        for name in ("CONFIG", "SMOKE_CONFIG", "TRAIN_CONFIG"):
            assert dataclasses.asdict(getattr(tmod, name)) == (
                dataclasses.asdict(getattr(jmod, name))), (tmod.__name__, name)
    assert torch_base.get_config("mixtral-8x7b") is torch_mixtral.CONFIG
    assert torch_base.get_config("qwen1.5-0.5b", smoke=True) is (
        torch_qwen15.SMOKE_CONFIG
    )
    for arch in torch_base.ARCH_IDS:
        for smoke in (False, True):
            assert torch_base.get_config(arch, smoke).name == (
                torch_base.get_config(arch).name + ("-smoke" if smoke else ""))
    assert torch_base.get_config("xlstm-125m") is torch_xlstm.CONFIG


def test_init_is_seeded_and_scaled():
    a = model.init(TCFG, 7, device="cpu")
    b = model.init(TCFG, torch.Generator().manual_seed(7), device="cpu")
    for (path, x), y in zip(tree_paths(a), tree_leaves(b)):
        assert torch.equal(x, y), path
    table = a["embed"]["table"]
    assert float(table.abs().max()) <= 2.0 * TCFG.d_model**-0.5 + 1e-6
    assert a["blocks"]["b0_attn"]["mixer"]["wq"]["bias"].abs().sum() == 0
    with pytest.raises(TypeError):
        model.init(TCFG, None, device="cpu")


@pytest.mark.parametrize("window", [None, 5])
def test_attention_matches_jax(window):
    rng = np.random.default_rng(8)
    spec_kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                   window=window, rope_theta=1e4, softcap=None, qkv_bias=True)
    jspec = jax_attention.AttnSpec(**spec_kw)
    tspec = attention.AttnSpec(**spec_kw)
    jp = jax_attention.init(jax.random.key(1), jspec, jnp.float32)
    jp["wq"]["bias"] = jnp.asarray(rng.standard_normal(32).astype(np.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    exp = jax_attention.apply_train(jp, jnp.asarray(x), jspec, jnp.float32)
    got = attention.apply_train(tp, torch.from_numpy(x), tspec, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL, atol=TOL)
    assert np.array_equal(
        attention.causal_mask(6, 6, window).numpy(),
        np.asarray(jax_attention.causal_mask(6, 6, window)),
    )


@pytest.mark.parametrize("fn", ["rmsnorm", "rope", "mlp", "softcap"])
def test_layers_match_jax(fn):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    if fn == "rmsnorm":
        scale = rng.standard_normal(16).astype(np.float32)
        exp = jax_layers.rmsnorm_apply(
            {"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6, jnp.float32)
        got = layers.rmsnorm_apply(
            {"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6,
            torch.float32)
    elif fn == "rope":
        pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
        exp = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    elif fn == "mlp":
        ws = {k: rng.standard_normal(s).astype(np.float32) * 0.2
              for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                           ("down", (24, 16)))}
        exp = jax_layers.mlp_apply(
            {k: {"kernel": jnp.asarray(v)} for k, v in ws.items()},
            jnp.asarray(x), jnp.float32)
        got = layers.mlp_apply(
            {k: {"kernel": torch.from_numpy(v)} for k, v in ws.items()},
            torch.from_numpy(x), torch.float32)
    else:
        exp = jax_layers.softcap(jnp.asarray(x) * 20, 30.0)
        got = layers.softcap(torch.from_numpy(x) * 20, 30.0)
        assert layers.softcap(torch.from_numpy(x), None) is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["mamba_moe", "mamba", "mlstm", "slstm"])
def test_recurrent_block_kinds_match_jax(kind):
    """Each recurrent kind built alone (Jamba's smoke widths, capacity 8.0)
    and run through the train form against the reference's block: the
    same leaves, xLSTM kinds without FFN and norm2, outputs and aux."""
    cfg_kw = dict(block_pattern=(kind,), num_layers=1)
    jcfg = dataclasses.replace(jax_jamba.SMOKE_CONFIG, **cfg_kw)
    tcfg = dataclasses.replace(torch_jamba.SMOKE_CONFIG, **cfg_kw)
    jp = jax_blocks.init(jax.random.key(5), jcfg, kind)
    paths = dict(tree_paths(blocks.init(0, tcfg, kind, "meta")))
    jpaths = dict(tree_paths(jax.tree.map(np.asarray, jp)))
    assert {k: tuple(v.shape) for k, v in paths.items()} == {
        k: v.shape for k, v in jpaths.items()}
    assert ("ffn" in jp) == (kind not in ("mlstm", "slstm"))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    x = np.random.default_rng(6).standard_normal((2, 9, 64)).astype(np.float32)
    exp, jaux = jax_blocks.apply_train(jp, jnp.asarray(x), jcfg, kind)
    got, aux = blocks.apply_train(tp, torch.from_numpy(x), tcfg, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL,
                               atol=TOL)
    for name in jaux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_long_sequence_takes_the_chunked_path_as_jax():
    """At S = 8192 (the real threshold and chunk sizes) both packages run
    their chunked attention; window and softcap on, outputs agree."""
    rng = np.random.default_rng(13)
    spec_kw = dict(d_model=8, num_heads=2, num_kv_heads=1, head_dim=4,
                   window=3000, rope_theta=1e4, softcap=30.0, qkv_bias=False)
    jspec = jax_attention.AttnSpec(**spec_kw)
    tspec = attention.AttnSpec(**spec_kw)
    jp = jax_attention.init(jax.random.key(3), jspec, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    x = rng.standard_normal((1, attention.CHUNKED_ATTN_THRESHOLD, 8))
    x = x.astype(np.float32)
    exp = jax_attention.apply_train(jp, jnp.asarray(x), jspec, jnp.float32)
    got = attention.apply_train(tp, torch.from_numpy(x), tspec, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The MoE kinds (Mixtral's `swa_moe`) at the smoke size
# ---------------------------------------------------------------------------

MOE_TOL = 2e-5  # the JAX package's fp32 tolerance


def _mixtral(cf=None, seed=0):
    """Mixtral's smoke configs (capacity factor ``cf`` in place of the
    droppless 8.0 when given) and one set of parameters in both packages."""
    import dataclasses

    jcfg, tcfg = jax_mixtral.SMOKE_CONFIG, torch_mixtral.SMOKE_CONFIG
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    jp = jax_model.init(jcfg, jax.random.key(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_logits_match_jax(seed, cf):
    """Mixtral's smoke model (window 16, 4 experts top-2): logits and both
    aux losses, droppless and at a capacity that drops."""
    jcfg, tcfg, jp, tp = _mixtral(cf, seed)
    tok = _tokens(seed, s=25)[:, :-1]
    exp, jaux = jax_model.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    got, aux = model.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    assert got.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=MOE_TOL,
                               atol=MOE_TOL)
    for name in jaux:
        assert float(aux[name]) > 0, name
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=MOE_TOL, atol=MOE_TOL, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax(remat):
    """The loss with both aux terms and its gradient w.r.t. every leaf,
    router and stacked experts included."""
    jcfg, tcfg, jp, tp = _mixtral(1.25)
    tok = _tokens(4, s=25)
    jl, jg = jax.value_and_grad(
        lambda p: jax_model.loss(jcfg, p, {"tokens": jnp.asarray(tok)},
                                 remat=remat)[0]
    )(jp)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tl, metrics = model.loss(
        tcfg, tp, {"tokens": torch.from_numpy(tok)}, remat=remat
    )
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=MOE_TOL,
                               atol=MOE_TOL)
    assert float(metrics["load_balance_loss"].detach()) > 0
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    assert any("ffn/router" in path for path in jgrads)
    for (path, _), g in zip(tree_paths(tp), grads):
        np.testing.assert_allclose(
            g.numpy(), jgrads[path], rtol=MOE_TOL, atol=MOE_TOL, err_msg=path
        )


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize(
    "pair", NEW_CONFIG_COPIES, ids=lambda p: p[1].__name__.split(".")[-1]
)
def test_new_configs_count_and_shape_as_jax(pair, which):
    """`parameter_count` and every leaf's shape from the meta device
    against `jax.eval_shape`, for the four new config copies."""
    jmod, tmod = pair
    jc = jmod.CONFIG if which == "full" else jmod.SMOKE_CONFIG
    tc = tmod.CONFIG if which == "full" else tmod.SMOKE_CONFIG
    jshapes = {
        k: tuple(v.shape) for k, v in tree_paths(
            jax.eval_shape(lambda k: jax_model.init(jc, k), jax.random.key(0))
        )
    }
    shapes = {k: tuple(v.shape) for k, v in
              tree_paths(model.init(tc, 0, device="meta"))}
    assert shapes == jshapes
    assert model.parameter_count(tc) == sum(
        int(np.prod(s)) for s in jshapes.values())


def test_mixtral_full_parameter_count():
    """Mixtral-8x7B at full depth: 46.70 B parameters, as the JAX package
    counts them; 16 of its 32 layers (the served depth) 23.48 B."""
    import dataclasses

    n = model.parameter_count(torch_mixtral.CONFIG)
    assert n == jax_model.parameter_count(jax_mixtral.CONFIG)
    assert round(n / 1e9, 2) == 46.70
    half = dataclasses.replace(torch_mixtral.CONFIG, num_layers=16)
    assert round(model.parameter_count(half) / 1e9, 2) == 23.48


@pytest.mark.parametrize("as_bits", [False, True])
def test_convert_round_trip_moe(as_bits):
    """The MoE tree (`ffn/router/kernel`, `ffn/gate`, `ffn/up`, `ffn/down`
    with their leading G axis) crosses both ways, fp32 exactly and bf16 bit
    for bit."""
    import dataclasses

    jcfg, tcfg, jp, tp = _mixtral()
    paths = dict(tree_paths(tp))
    g, e = tcfg.num_groups, tcfg.num_experts
    assert paths["blocks/b0_swa_moe/ffn/gate"].shape == (
        g, e, tcfg.d_model, tcfg.d_ff)
    assert paths["blocks/b0_swa_moe/ffn/router/kernel"].shape == (
        g, tcfg.d_model, e)
    back = convert.params_to_jax(tp)
    for (path, a), (_, b) in zip(
        tree_paths(jax.tree.map(np.asarray, jp)), tree_paths(back)
    ):
        assert np.array_equal(a, b), path
    cfg16 = dataclasses.replace(tcfg, param_dtype="bfloat16")
    tree16 = jax.tree.map(lambda p: np.asarray(p.astype(jnp.bfloat16)), jp)
    tree16 = jax.tree.map(
        lambda a: a.view(np.uint16) if as_bits else a.astype(np.float32),
        tree16)
    tp16 = convert.params_from_jax(tree16, cfg16, "cpu")
    back16 = convert.params_to_jax(tp16, bf16_as_bits=as_bits)
    for (path, a), (_, b) in zip(tree_paths(tree16), tree_paths(back16)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


# ---------------------------------------------------------------------------
# truncated_normal_init: one draw up to SINGLE_DRAW_MAX_BYTES, slices above
# ---------------------------------------------------------------------------


def _single_draw_before_slicing(generator, shape, scale, dtype, device):
    """`truncated_normal_init` as it was before large leaves were drawn in
    slices: the whole leaf in one float32 draw."""
    u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        layers._CDF_LO, layers._CDF_HI, generator=generator
    )
    x = torch.erfinv(u.mul_(2.0).sub_(1.0)).mul_(2.0**0.5).clamp_(-2.0, 2.0)
    return x.mul_(scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_truncated_normal_single_draw_keeps_its_bits(dtype):
    for shape in ((3, 64, 48), (17,), (2, 8, 16, 32)):
        got = layers.truncated_normal_init(
            torch.Generator().manual_seed(5), shape, 0.1, dtype, "cpu")
        want = _single_draw_before_slicing(
            torch.Generator().manual_seed(5), shape, 0.1, dtype, "cpu")
        assert got.dtype == dtype and torch.equal(got, want), shape


@pytest.mark.parametrize("name", ["qwen2", "gemma2"])
def test_todays_models_draw_the_same_weights(monkeypatch, name):
    """Qwen2-0.5B's and Gemma2-2B's largest float32 leaf (Gemma2's
    embedding, 2.36 GB) is under the one-draw size, so their full configs
    draw every leaf in one piece; at the smoke size `model.init` gives the
    bits of the one-draw function leaf for leaf."""
    cfg = {"qwen2": torch_cfg, "gemma2": torch_gemma}[name]
    largest = max(math.prod(l.shape) for l in
                  tree_leaves(model.init(cfg.CONFIG, 0, device="meta")))
    assert largest * 4 <= layers.SINGLE_DRAW_MAX_BYTES
    new = model.init(cfg.SMOKE_CONFIG, 11, device="cpu")
    monkeypatch.setattr(layers, "truncated_normal_init",
                        _single_draw_before_slicing)
    old = model.init(cfg.SMOKE_CONFIG, 11, device="cpu")
    for (path, a), b in zip(tree_paths(new), tree_leaves(old)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("rows_per_slice", [1, 3])
def test_truncated_normal_large_leaf_is_drawn_in_slices(monkeypatch,
                                                        rows_per_slice):
    """Over the one-draw size (made small here) the leaf is drawn slice by
    slice along its leading axis: each float32 draw is at most that size,
    values stay within ±2·scale, mean ≈ 0 and variance ≈ the truncated
    normal's (0.7737·scale²)."""
    shape, scale = (7, 40, 50), 0.3
    per_row = 40 * 50 * 4
    monkeypatch.setattr(layers, "SINGLE_DRAW_MAX_BYTES",
                        per_row * rows_per_slice + 4)
    drawn = []
    real_empty = torch.empty

    def empty(*size, **kw):
        t = real_empty(*size, **kw)
        if kw.get("dtype") == torch.float32:
            drawn.append(t.numel())
        return t

    monkeypatch.setattr(layers.torch, "empty", empty)
    x = layers.truncated_normal_init(
        torch.Generator().manual_seed(3), shape, scale, torch.bfloat16, "cpu")
    monkeypatch.undo()
    assert x.shape == shape and x.dtype == torch.bfloat16
    assert drawn == [40 * 50 * min(rows_per_slice, 7 - i)
                     for i in range(0, 7, rows_per_slice)]
    x32 = x.to(torch.float32)
    assert float(x32.abs().max()) <= 2.0 * scale
    var = 0.7737413 * scale**2  # Var of N(0, 1) truncated to (-2, 2)
    assert abs(float(x32.mean())) < 0.02 * scale
    assert abs(float(x32.var()) / var - 1.0) < 0.03
    # each slice is its own draw: not a copy of the first
    assert not torch.equal(x[0], x[1])
