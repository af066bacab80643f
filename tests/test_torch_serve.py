"""The port's serving path against the JAX package on the CPU (fp32 smoke
configs): `model.prefill` / `model.decode_step` logits at every step and
the caches key for key through `convert`, incl. Gemma2's ring buffer past
its window of 16; decode against a teacher-forced forward; the chunked
long-sequence attention against the JAX one; `build_serve_artifacts`
shapes; and a decode step that reads nothing back to the host."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jax_gemma
from repro.configs import mixtral_8x7b as jax_mixtral
from repro.configs import qwen2_0_5b as jax_qwen
from repro.configs.base import DECODE_32K as JAX_DECODE_32K
from repro.configs.base import PREFILL_32K as JAX_PREFILL_32K
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro_torch import compat
from repro_torch.configs import gemma2_2b as torch_gemma
from repro_torch.configs import mixtral_8x7b as torch_mixtral
from repro_torch.configs import qwen2_0_5b as torch_qwen
from repro_torch.configs.base import DECODE_32K, PREFILL_32K, ShapeConfig
from repro_torch.launch import serve
from repro_torch.models import attention, convert, model
from repro_torch.tree import tree_map, tree_paths

TOL = 1e-4  # rtol = atol, fp32 on the CPU: sums in another order only

CONFIGS = {
    "qwen2": (jax_qwen.SMOKE_CONFIG, torch_qwen.SMOKE_CONFIG),
    "gemma2": (jax_gemma.SMOKE_CONFIG, torch_gemma.SMOKE_CONFIG),
    # Gemma2-2B's head_dim (256) at smoke width: the model path whose
    # prefill the card serves through the wgmma design's 64-key tiles
    "gemma2_d256": (dataclasses.replace(jax_gemma.SMOKE_CONFIG, head_dim=256),
                    dataclasses.replace(torch_gemma.SMOKE_CONFIG, head_dim=256)),
    # Mixtral-8x7B's smoke model: window-16 attention and 4 experts top-2
    # (droppless capacity 8.0) on every layer
    "mixtral": (jax_mixtral.SMOKE_CONFIG, torch_mixtral.SMOKE_CONFIG),
}
FULL = {"qwen2": (jax_qwen, torch_qwen), "gemma2": (jax_gemma, torch_gemma),
        "mixtral": (jax_mixtral, torch_mixtral)}


def _params(name, seed=0):
    jcfg, tcfg = CONFIGS[name]
    jp = jax_model.init(jcfg, jax.random.key(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _tokens(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_caches_equal(jax_caches, torch_caches):
    want = dict(tree_paths(jax.tree.map(np.asarray, jax_caches)))
    got = dict(tree_paths(convert.caches_to_jax(torch_caches)))
    assert want.keys() == got.keys()
    for path in want:
        assert got[path].shape == want[path].shape, path
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_allclose(got[path], want[path], rtol=TOL, atol=TOL,
                                   err_msg=path)


@pytest.mark.parametrize(
    "name,prompt,steps",
    [("qwen2", 9, 12),     # global layers only
     ("gemma2", 10, 12),   # the ring buffer wraps during decode (window 16)
     ("gemma2", 20, 6),    # the prompt already fills the window: reordering
     ("gemma2_d256", 20, 6),   # the same at head_dim 256
     ("mixtral", 10, 12),  # MoE; the window-16 ring wraps during decode
     ("mixtral", 20, 6)],  # MoE; the prompt already fills the ring
)
def test_prefill_and_decode_match_jax(name, prompt, steps):
    jcfg, tcfg = CONFIGS[name]
    jp, tp = _params(name)
    tok = _tokens(jcfg, prompt, 2, prompt + steps)
    max_len = prompt + steps
    jl, jc = jax_model.prefill(jcfg, jp, {"tokens": jnp.asarray(tok[:, :prompt])},
                               max_len=max_len)
    tl, tc = model.prefill(tcfg, tp, {"tokens": torch.from_numpy(tok[:, :prompt])},
                           max_len=max_len)
    assert tl.shape == (2, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_caches_equal(jc, tc)
    for t in range(steps - 1):
        nxt = tok[:, prompt + t:prompt + t + 1]
        jl, jc = jax_model.decode_step(jcfg, jp, jc, jnp.asarray(nxt))
        tl, tc2 = model.decode_step(tcfg, tp, tc, torch.from_numpy(nxt))
        assert tc2 is tc  # written in place, the same dict returned
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
    _assert_caches_equal(jc, tc)


@pytest.mark.parametrize("name", ["qwen2", "gemma2", "mixtral"])
def test_decode_equals_teacher_forced_forward(name):
    """In the port alone: prefill + decode steps give the full forward's
    logits at the same positions."""
    _, tcfg = CONFIGS[name]
    _, tp = _params(name, seed=1)
    prompt, steps = 7, 14
    tok = torch.from_numpy(_tokens(tcfg, 3, 2, prompt + steps))
    full, _ = model.forward(tcfg, tp, {"tokens": tok}, remat=False)
    logits, caches = model.prefill(tcfg, tp, {"tokens": tok[:, :prompt]},
                                   max_len=prompt + steps)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, prompt - 1].detach().numpy(),
                               rtol=TOL, atol=TOL)
    for t in range(steps - 1):
        logits, caches = model.decode_step(
            tcfg, tp, caches, tok[:, prompt + t:prompt + t + 1]
        )
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, prompt + t].detach().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=f"step {t}")


def _small_chunks(monkeypatch):
    for mod in (jax_attention, attention):
        monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 16)
        monkeypatch.setattr(mod, "CHUNK_Q", 8)
        monkeypatch.setattr(mod, "CHUNK_K", 8)


@pytest.mark.parametrize(
    "window,softcap", [(None, None), (5, None), (None, 30.0), (12, 50.0)]
)
def test_chunked_attention_matches_jax(monkeypatch, window, softcap):
    """`_sdpa_chunked` (what `apply_train` takes at S ≥ the threshold),
    thresholds made small in both packages: outputs and the gradients of
    the training form."""
    _small_chunks(monkeypatch)
    rng = np.random.default_rng(12)
    spec_kw = dict(d_model=32, num_heads=6, num_kv_heads=2, head_dim=8,
                   window=window, rope_theta=1e4, softcap=softcap,
                   qkv_bias=True)
    jspec = jax_attention.AttnSpec(**spec_kw)
    tspec = attention.AttnSpec(**spec_kw)
    jp = jax_attention.init(jax.random.key(2), jspec, jnp.float32)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    ct = rng.standard_normal((2, 32, 32)).astype(np.float32)

    def jloss(p, xx):
        y = jax_attention.apply_train(p, xx, jspec, jnp.float32)
        return jnp.sum(y * ct), y

    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(jp, jnp.asarray(x))
    tp = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a).copy()).requires_grad_(True), jp
    )
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = attention.apply_train(tp, tx, tspec, torch.float32)
    (ty * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=TOL, atol=TOL)
    for path, g in tree_paths(jax.tree.map(np.asarray, jg)):
        leaf = dict(tree_paths(tp))[path]
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=TOL, atol=TOL,
                                   err_msg=path)


def test_chunked_path_is_taken_and_prefill_matches_jax_chunked(monkeypatch):
    """With the threshold small the JAX prefill goes through its chunked
    path; the port's prefill (flash plain version at every length) agrees,
    and the port's training form does run `_sdpa_chunked`."""
    _small_chunks(monkeypatch)
    calls = []
    real = attention._sdpa_chunked
    monkeypatch.setattr(attention, "_sdpa_chunked",
                        lambda *a: calls.append(1) or real(*a))
    jcfg, tcfg = CONFIGS["gemma2"]
    jp, tp = _params("gemma2", seed=2)
    tok = _tokens(jcfg, 4, 2, 32)
    jl, jc = jax_model.prefill(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               max_len=40)
    tl, tc = model.prefill(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                           max_len=40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_caches_equal(jc, tc)
    assert not calls
    exp, _ = jax_model.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               remat=False)
    got, _ = model.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                           remat=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               rtol=TOL, atol=TOL)
    assert len(calls) == tcfg.num_layers


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("name", ["qwen2", "gemma2", "mixtral"])
def test_serve_artifact_shapes_match_jax(name, which):
    """Parameter, cache and input shapes from the meta device, key for key
    against `jax.eval_shape` of the reference — nothing is allocated."""
    jcfg, tcfg = CONFIGS[name]
    if which == "full":
        jcfg, tcfg = (mod.CONFIG for mod in FULL[name])
    for jshape, tshape in ((JAX_DECODE_32K, DECODE_32K),
                           (JAX_PREFILL_32K, PREFILL_32K)):
        art = serve.build_serve_artifacts(tcfg, tshape, device="cpu")
        b, s = tshape.global_batch, tshape.seq_len
        jcache = jax.eval_shape(lambda: jax_model.init_caches(jcfg, b, s))
        jparams = jax.eval_shape(lambda k: jax_model.init(jcfg, k),
                                 jax.random.key(0))
        for want, got in ((jcache, art.cache_shapes),
                          (jparams, art.param_shapes)):
            want = {p: (tuple(l.shape), str(l.dtype)) for p, l in tree_paths(want)}
            got = {p: (tuple(l.shape), str(l.dtype).removeprefix("torch."))
                   for p, l in tree_paths(got)}
            assert got == want
        assert all(l.device.type == "meta" for _, l in
                   tree_paths(art.cache_shapes))
        tokens = (art.input_shapes if tshape.kind == "decode"
                  else art.input_shapes["tokens"])
        assert tuple(tokens.shape) == (
            (b, 1) if tshape.kind == "decode" else (b, s)
        )


def test_serve_artifacts_run_the_loop_on_the_cpu():
    """prefill_fn → greedy step_fn calls, as examples/serve_decode.py."""
    _, tcfg = CONFIGS["gemma2"]
    _, tp = _params("gemma2", seed=3)
    art = serve.build_serve_artifacts(tcfg, ShapeConfig("t", 30, 2, "prefill"),
                                      device="cpu")
    logits, caches = art.prefill_fn(
        tp, {"tokens": torch.from_numpy(_tokens(tcfg, 5, 2, 12))}
    )
    token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(10):
        logits, caches = art.step_fn(tp, caches, token)
        token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    assert logits.shape == (2, 1, tcfg.vocab_size)
    assert caches["b0_local"]["pos"].tolist() == [22]
    assert caches["b0_local"]["k"].shape[2] == tcfg.sliding_window
    assert caches["b1_global"]["k"].shape[2] == 30
    assert torch.is_inference(caches["b1_global"]["k"])


def _host_reads_in_decode(monkeypatch, name, key):
    """Tensor reads back to the host during two decode steps of ``name``'s
    smoke model after an 18-token prompt; asserts ``key``'s cache moved."""
    _, tcfg = CONFIGS[name]
    _, tp = _params(name)
    tok = torch.from_numpy(_tokens(tcfg, 6, 2, 20))
    _, caches = model.prefill(tcfg, tp, {"tokens": tok[:, :18]}, max_len=24)
    reads = []

    def forbid(name):
        def read(self, *a, **k):
            reads.append(name)
            raise AssertionError(f"decode_step called Tensor.{name}")
        return read

    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__bool__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, forbid(name))
    with torch.inference_mode():
        for t in (18, 19):
            model.decode_step(tcfg, tp, caches, tok[:, t:t + 1])
    monkeypatch.undo()
    assert caches[key]["pos"].tolist() == [20] * tcfg.num_groups
    return reads


def test_decode_step_reads_nothing_back_to_the_host(monkeypatch):
    """No `.item()`, `int()`, `bool()`, `.tolist()` or `.cpu()` of a tensor
    inside `decode_step`: on the card each would wait for the device."""
    assert _host_reads_in_decode(monkeypatch, "gemma2", "b0_local") == []


def test_moe_decode_step_reads_nothing_back_to_the_host(monkeypatch):
    """The same for Mixtral's smoke model: routing, dispatch and combine
    of the MoE FFN stay on the device (shapes give the capacity)."""
    assert _host_reads_in_decode(monkeypatch, "mixtral", "b0_swa_moe") == []


def test_caches_cross_packages_and_are_checked():
    jcfg, tcfg = CONFIGS["gemma2"]
    caches = jax.tree.map(np.asarray, jax_model.init_caches(jcfg, 2, 24))
    caches["b0_local"]["k"] = np.random.default_rng(0).standard_normal(
        caches["b0_local"]["k"].shape).astype(np.float32)
    tc = convert.caches_from_jax(caches, tcfg, "cpu")
    assert tc["b1_global"]["pos"].dtype == torch.int32
    _assert_caches_equal(caches, tc)
    bad = dict(caches)
    bad["b1_global"] = dict(caches["b1_global"], pos=np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="pos"):
        convert.caches_from_jax(bad, tcfg, "cpu")
    with pytest.raises(ValueError, match="differ"):
        convert.caches_from_jax({"b0_local": caches["b0_local"]}, tcfg, "cpu")
    cfg16 = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    t16 = convert.caches_from_jax(caches, cfg16, "cpu")
    assert t16["b0_local"]["k"].dtype == torch.bfloat16
    back = convert.caches_to_jax(t16, bf16_as_bits=True)
    assert back["b0_local"]["k"].dtype == np.uint16


def test_prompt_longer_than_the_cache_is_refused():
    _, tcfg = CONFIGS["qwen2"]
    _, tp = _params("qwen2")
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(tcfg, tp, {"tokens": torch.zeros(1, 9, dtype=torch.int32)},
                      max_len=8)


def test_cache_dtype_follows_the_compute_dtype():
    cfg = torch_qwen.CONFIG
    caches = model.init_caches(cfg, 4, 64, device="meta")
    k = caches["b0_attn"]["k"]
    assert k.dtype == compat.dtype_of(cfg.compute_dtype)
    assert tuple(k.shape) == (cfg.num_groups, 4, 64, cfg.num_kv_heads,
                              cfg.resolved_head_dim)
    assert tree_map(lambda t: t.device.type, caches)["b0_attn"]["pos"] == "meta"
