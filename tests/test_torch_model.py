"""Port `models/` against the JAX package at the smoke size (fp32, CPU):
parameters cross through `convert.params_from_jax`, the same tokens go
through both, logits and loss agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jax_gemma
from repro.configs import qwen2_0_5b as jax_cfg
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs import base as torch_base
from repro_torch.configs import gemma2_2b as torch_gemma
from repro_torch.configs import qwen2_0_5b as torch_cfg
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
    with pytest.raises(NotImplementedError):
        torch_base.get_config("mixtral-8x7b")


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


@pytest.mark.parametrize("kind", ["attn_moe", "mamba", "mlstm"])
def test_unported_block_kinds_name_the_roadmap(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        blocks.init(0, TCFG, kind, "cpu")


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
