"""The four architectures of the recurrent slice against the JAX package on
the CPU, at their smoke configs (fp32): Jamba (Mamba, MoE and attention
blocks), xLSTM (mLSTM and sLSTM), LLaVA-NeXT (the vision-patch frontend)
and MusicGen (the audio-codec frontend, tokens only).

Parameters come from the reference's init through `models.convert`;
tokens (and patch embeddings) are drawn once with numpy and given to both;
the JAX side is jitted. `forward`, `loss` with its gradients, the prefill
caches and each `decode_step` are held against the reference; decoding
against the port's own teacher-forced forward; caches cross both ways
through `convert`; `build_serve_artifacts` and one `launch/train.py` step
run for Jamba and LLaVA. Tolerances (rtol = atol): 1e-4, 1e-3 for xLSTM
(mLSTM's parallel form against its recurrence, `tests/test_ssm.py`'s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat as jcompat
from repro.configs import base as jbase
from repro.configs import jamba_1_5_large_398b as jax_jamba
from repro.configs import llava_next_34b as jax_llava
from repro.configs import musicgen_large as jax_musicgen
from repro.configs import xlstm_125m as jax_xlstm
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.models import model as jax_model
from repro_torch.configs import base
from repro_torch.configs import jamba_1_5_large_398b as torch_jamba
from repro_torch.configs import llava_next_34b as torch_llava
from repro_torch.configs import musicgen_large as torch_musicgen
from repro_torch.configs import xlstm_125m as torch_xlstm
from repro_torch.core import dpsgd
from repro_torch.data import DataConfig, SyntheticTokenStream, make_batch_fn
from repro_torch.launch import mesh, serve, train
from repro_torch.models import convert, model
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves, tree_paths

MODULES = {
    "jamba": (jax_jamba, torch_jamba),
    "xlstm": (jax_xlstm, torch_xlstm),
    "llava": (jax_llava, torch_llava),
    "musicgen": (jax_musicgen, torch_musicgen),
}
TOL = {"jamba": 1e-4, "xlstm": 1e-3, "llava": 1e-4, "musicgen": 1e-4}
PROMPT, STEPS = 9, 5


def _cfgs(name):
    jmod, tmod = MODULES[name]
    return jmod.SMOKE_CONFIG, tmod.SMOKE_CONFIG


def _params(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jp = jax_model.init(jcfg, jax.random.key(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                       "cpu")


def _inputs(cfg, seed, b, s):
    """{"tokens": [b, s]} (and ``patch_embeds [b, P, d]`` for the VLM) as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _offset(cfg):
    return cfg.num_patches if cfg.frontend == "vision_patches" else 0


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _assert_caches_equal(jax_caches, torch_caches, tol):
    want = dict(tree_paths(jax.tree.map(np.asarray, jax_caches)))
    got = dict(tree_paths(convert.caches_to_jax(torch_caches)))
    assert want.keys() == got.keys()
    for path in want:
        assert got[path].shape == want[path].shape, path
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_allclose(got[path], want[path], rtol=tol, atol=tol,
                                   err_msg=path)


@pytest.mark.parametrize("name", list(MODULES))
def test_forward_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    inputs = _inputs(jcfg, 1, 2, 13)
    exp, jaux = jax.jit(lambda p, i: jax_model.forward(
        jcfg, p, i, remat=False))(jp, _jax(inputs))
    got, aux = model.forward(tcfg, tp, _torch(inputs), remat=False)
    assert got.shape == (2, 13 + _offset(jcfg), jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL[name],
                               atol=TOL[name])
    for key in jaux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=TOL[name], atol=TOL[name], err_msg=key)


@pytest.mark.parametrize("name", list(MODULES))
def test_loss_and_grads_match_jax(name):
    """The loss (the VLM's over text positions only) and its gradient with
    respect to every leaf, `patch_proj` and Mamba's `a_log` included."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name, seed=1)
    batch = _inputs(jcfg, 2, 2, 12)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.loss(jcfg, p, b)[0]))(jp, _jax(batch))
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tl, metrics = model.loss(tcfg, tp, _torch(batch))
    grads = torch.autograd.grad(tl, leaves)
    tol = TOL[name]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol,
                               atol=tol)
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    for (path, _), g in zip(tree_paths(tp), grads):
        assert bool(torch.isfinite(g).all()), path
        np.testing.assert_allclose(g.numpy(), jgrads[path], rtol=tol,
                                   atol=tol, err_msg=path)


@pytest.mark.parametrize("name", list(MODULES))
def test_prefill_and_decode_match_jax(name):
    """The prefill's logits and caches (recurrent states from the train
    form in the port, from S decode steps in the reference), then each
    decode step's logits and the caches after them."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name, seed=2)
    inputs = _inputs(jcfg, 3, 2, PROMPT + STEPS)
    tokens = inputs.pop("tokens")
    inputs["tokens"] = tokens[:, :PROMPT]
    max_len = _offset(jcfg) + PROMPT + STEPS
    jl, jc = jax.jit(lambda p, i: jax_model.prefill(jcfg, p, i, max_len))(
        jp, _jax(inputs))
    tl, tc = model.prefill(tcfg, tp, _torch(inputs), max_len=max_len)
    tol = TOL[name]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    _assert_caches_equal(jc, tc, tol)
    jstep = jax.jit(lambda p, c, t: jax_model.decode_step(jcfg, p, c, t))
    for t in range(PROMPT, PROMPT + STEPS - 1):
        nxt = tokens[:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(nxt))
        tl, tc2 = model.decode_step(tcfg, tp, tc, torch.from_numpy(nxt))
        assert tc2 is tc  # written in place, the same dict returned
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"token {t}")
    _assert_caches_equal(jc, tc, tol)


@pytest.mark.parametrize("name", list(MODULES))
def test_decode_equals_teacher_forced_forward(name):
    """In the port alone: prefill + decode steps give the full forward's
    logits at the same positions (as tests/test_models_smoke.py)."""
    _, tcfg = _cfgs(name)
    _, tp = _params(name, seed=4)
    inputs = _torch(_inputs(tcfg, 5, 2, PROMPT + STEPS))
    full, _ = model.forward(tcfg, tp, inputs, remat=False)
    tokens = inputs["tokens"]
    off = _offset(tcfg)
    logits, caches = model.prefill(
        tcfg, tp, dict(inputs, tokens=tokens[:, :PROMPT]),
        max_len=off + PROMPT + STEPS)
    tol = TOL[name]
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, off + PROMPT - 1].detach().numpy(),
                               rtol=tol, atol=tol)
    for t in range(PROMPT, PROMPT + STEPS - 1):
        logits, caches = model.decode_step(tcfg, tp, caches,
                                           tokens[:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, off + t].detach().numpy(),
                                   rtol=tol, atol=tol, err_msg=f"token {t}")


@pytest.mark.parametrize("name", ["jamba", "xlstm"])
def test_caches_cross_both_ways(name):
    """The reference's empty caches (mLSTM/sLSTM ``m`` at −inf), filled with
    noise, cross into the port and back bit for bit; bf16 conv states
    cross as bits; a wrong state shape is refused."""
    jcfg, tcfg = _cfgs(name)
    caches = jax.tree.map(np.asarray, jax_model.init_caches(jcfg, 2, 12))
    rng = np.random.default_rng(0)
    noisy = jax.tree.map(
        lambda a: a if not np.issubdtype(a.dtype, np.floating) else np.where(
            np.isinf(a), a, rng.standard_normal(a.shape).astype(a.dtype)),
        caches)
    tc = convert.caches_from_jax(noisy, tcfg, "cpu")
    empty = model.init_caches(tcfg, 2, 12, "cpu")
    for (path, a), (_, b) in zip(tree_paths(tc), tree_paths(empty)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
    back = dict(tree_paths(convert.caches_to_jax(tc)))
    for path, a in tree_paths(noisy):
        assert np.array_equal(back[path], a), path
    if name == "xlstm":
        assert np.isneginf(back["b3_slstm/m"]).all()
        assert bool(torch.isneginf(empty["b0_mlstm"]["m"]).all())
        bad = dict(noisy, b0_mlstm=dict(noisy["b0_mlstm"],
                                        m=noisy["b0_mlstm"]["m"][..., :1]))
    else:
        cfg16 = dataclasses.replace(tcfg, compute_dtype="bfloat16")
        t16 = convert.caches_from_jax(noisy, cfg16, "cpu")
        assert t16["b0_mamba"]["conv"].dtype == torch.bfloat16
        assert t16["b0_mamba"]["ssm"].dtype == torch.float32
        assert convert.caches_to_jax(
            t16, bf16_as_bits=True)["b0_mamba"]["conv"].dtype == np.uint16
        bad = dict(noisy, b0_mamba=dict(noisy["b0_mamba"],
                                        ssm=noisy["b0_mamba"]["ssm"][..., 1:]))
    with pytest.raises(ValueError, match="shape"):
        convert.caches_from_jax(bad, tcfg, "cpu")


@pytest.mark.parametrize("name", ["jamba", "llava"])
def test_serve_artifacts_run_the_loop(name):
    """Shapes from the meta device against the reference's (`init`,
    `init_caches`, its prefill inputs: the VLM's text tokens plus bf16
    patch embeddings), then prefill_fn and greedy step_fn calls whose
    logits equal `model.forward`'s on the generated sequence."""
    jcfg, tcfg = _cfgs(name)
    b, s = 2, 24
    art = serve.build_serve_artifacts(
        tcfg, base.ShapeConfig("t", s, b, "prefill"), device="cpu")
    jparams = jax.eval_shape(lambda k: jax_model.init(jcfg, k),
                             jax.random.key(0))
    jcache = jax.eval_shape(lambda: jax_model.init_caches(jcfg, b, s))
    for want, got in ((jparams, art.param_shapes), (jcache, art.cache_shapes)):
        assert {p: (tuple(l.shape), str(l.dtype)) for p, l in
                tree_paths(want)} == {
            p: (tuple(l.shape), str(l.dtype).removeprefix("torch."))
            for p, l in tree_paths(got)}
    text = s - _offset(tcfg)
    want_inputs = {"tokens": ((b, text), torch.int32)}
    if name == "llava":
        want_inputs["patch_embeds"] = ((b, tcfg.num_patches, tcfg.d_model),
                                       torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            art.input_shapes.items()} == want_inputs

    _, tp = _params(name, seed=6)
    inputs = _torch(_inputs(tcfg, 7, b, text - 6))
    logits, caches = art.prefill_fn(tp, inputs)
    generated = [logits[:, -1].argmax(-1).to(torch.int32)[:, None]]
    for _ in range(5):
        logits, caches = art.step_fn(tp, caches, generated[-1])
        generated.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
    seq = torch.cat([inputs["tokens"]] + generated[:-1], dim=1)
    full, _ = model.forward(tcfg, tp, dict(inputs, tokens=seq), remat=False)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=TOL[name], atol=TOL[name])
    assert all(torch.is_inference(t) for t in tree_leaves(caches))


@pytest.mark.parametrize("name", ["jamba", "llava"])
def test_one_train_step_matches_jax(name):
    """One step of the launcher (one agent, `data` layout) from the
    reference's initial state on the same batch (the VLM's with patch
    embeddings from `data.pipeline`): the loss and every parameter."""
    jcfg, tcfg = _cfgs(name)
    kw = dict(agent_layout="data", gossip="none", microbatch=1,
              learning_rate=0.05, remat="none")
    jt, tt = jbase.TrainConfig(**kw), base.TrainConfig(**kw)
    s = 16
    jm = jmesh.make_test_mesh((1, 1))
    with jcompat.set_mesh(jm):
        jart = jtrain.build_train_artifacts(
            jcfg, jt, jbase.ShapeConfig("one", s, 2, "train"), jm, None)
        jstate = jart.init_state(jax.random.key(0))
        jstep = jart.jit(donate=False)
    art = train.build_train_artifacts(
        tcfg, tt, base.ShapeConfig("one", s, 2, "train"),
        mesh.make_test_mesh((1, 1)), None, device="cpu")
    assert {k: tuple(v.shape) for k, v in art.batch_shapes.items()} == {
        k: tuple(v.shape) for k, v in jart.batch_shapes.items()}
    agent0 = jax.tree.map(lambda x: np.asarray(x[0]), jstate["params"])
    params = dpsgd.replicate_for_agents(
        convert.params_from_jax(agent0, tcfg, "cpu"), 1)
    state = {"params": params, "opt": sgd.init(params), "step": 0}
    data = SyntheticTokenStream(DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=s, num_agents=1, seed=1))
    batch = make_batch_fn(data, art.batch_shapes, tcfg.vocab_size)(0)
    assert ("patch_embeds" in batch) == (name == "llava")
    with jcompat.set_mesh(jm):
        jstate, jmet = jstep(jstate, batch)
    state, met = art.step_fn(state, batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    want = dict(tree_paths(jax.tree.map(np.asarray, jstate["params"])))
    got = dict(tree_paths(convert.params_to_jax(state["params"])))
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
