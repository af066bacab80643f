"""The port's recurrent mixers (`repro_torch.models.ssm`) against the JAX
package's on the CPU: Mamba, mLSTM and sLSTM, each in its train form, its
prefill state, its empty state and its decode step, with gradients and in
bf16. Parameters come from the reference's init and cross as numpy; inputs
are drawn once with numpy from fixed seeds and given to both packages; the
JAX side is jitted.

Tolerances (rtol = atol): 2e-5 where the port takes the reference's order
of operations (decode steps, sLSTM), `tests/test_ssm.py`'s 1e-4 (Mamba) and
1e-3 (mLSTM) where it computes by another route (Mamba's chunked loop for
the associative scan, mLSTM's closed-form prefill state), 2e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

EXACT = 2e-5
ROUTE = {"mamba": 1e-4, "mlstm": 1e-3, "slstm": EXACT}
BF16 = 2e-2

SPECS = {
    "mamba": (jssm.MambaSpec(d_model=16, d_state=4, d_conv=3, expand=2),
              ssm.MambaSpec(d_model=16, d_state=4, d_conv=3, expand=2)),
    "mlstm": (jssm.MLSTMSpec(d_model=16, num_heads=2),
              ssm.MLSTMSpec(d_model=16, num_heads=2)),
    "slstm": (jssm.SLSTMSpec(d_model=12, num_heads=2),
              ssm.SLSTMSpec(d_model=12, num_heads=2)),
}


def _to_torch(tree):
    """A JAX tree → torch tensors of the same values (bf16 leaves as bf16)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, tree)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _params(name, dtype=jnp.float32, seed=0):
    jspec, _ = SPECS[name]
    jp = getattr(jssm, f"{name}_init")(jax.random.key(seed), jspec, dtype)
    return jp, _to_torch(jp)


def _x(name, b, s, seed=1, dtype=np.float32):
    d = SPECS[name][0].d_model
    x = np.random.default_rng(seed).standard_normal((b, s, d))
    return x.astype(dtype)


def _jax_train(name, dtype=jnp.float32):
    jspec, _ = SPECS[name]
    fn = getattr(jssm, f"{name}_apply_train")
    return jax.jit(lambda p, x: fn(p, x, jspec, dtype))


def _jax_decode(name, dtype=jnp.float32):
    jspec, _ = SPECS[name]
    fn = getattr(jssm, f"{name}_apply_decode")
    return jax.jit(lambda p, x, s: fn(p, x, s, jspec, dtype))


def _jax_state(name, b, dtype=jnp.float32):
    return getattr(jssm, f"{name}_init_state")(b, SPECS[name][0], dtype)


def _torch_state(name, b, dtype=torch.float32):
    fn = getattr(ssm, f"{name}_init_state")
    spec = SPECS[name][1]
    if name == "mamba":
        return fn(b, spec, dtype, "cpu")
    return fn(b, spec, "cpu")


def _jax_states_after(name, jp, x):
    """The reference's way to a prefill state: its decode step from the
    empty state, once per token."""
    step = _jax_decode(name)
    state = _jax_state(name, x.shape[0])
    for t in range(x.shape[1]):
        _, state = step(jp, jnp.asarray(x[:, t:t + 1]), state)
    return state


def _assert_states(got, want, tol, what=""):
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(_np(got[key]), want[key].astype(np.float32),
                                   rtol=tol, atol=tol, err_msg=f"{what} {key}")


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("s", [1, 12, 37])
def test_train_form_matches_jax(name, s):
    jp, tp = _params(name)
    x = _x(name, 2, s)
    want = _jax_train(name)(jp, jnp.asarray(x))
    got = getattr(ssm, f"{name}_apply_train")(
        tp, torch.from_numpy(x), SPECS[name][1], torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = ROUTE[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize(
    "s,chunk",
    [(1, ssm.SCAN_CHUNK),                      # one step
     (40, ssm.SCAN_CHUNK),                     # S < chunk
     (ssm.SCAN_CHUNK + 1, ssm.SCAN_CHUNK),     # one step into a second chunk
     (23, 5)],                                 # many chunks, the last ragged
)
def test_mamba_chunked_scan_matches_jax(monkeypatch, s, chunk):
    """Output and prefill state across chunk edges: the state against the
    reference's S decode steps."""
    monkeypatch.setattr(ssm, "SCAN_CHUNK", chunk)
    jp, tp = _params("mamba")
    x = _x("mamba", 2, s, seed=s)
    want = _jax_train("mamba")(jp, jnp.asarray(x))
    got, state = ssm.mamba_prefill(tp, torch.from_numpy(x), SPECS["mamba"][1],
                                   torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ROUTE["mamba"], atol=ROUTE["mamba"])
    _assert_states(state, _jax_states_after("mamba", jp, x), ROUTE["mamba"])


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_prefill_state_equals_stepping_in_jax(name):
    """mLSTM's closed-form state and sLSTM's loop carry against the
    reference's S decode steps."""
    jp, tp = _params(name)
    x = _x(name, 2, 11)
    _, state = getattr(ssm, f"{name}_prefill")(
        tp, torch.from_numpy(x), SPECS[name][1], torch.float32)
    _assert_states(state, _jax_states_after(name, jp, x), ROUTE[name])


@pytest.mark.parametrize("name", list(SPECS))
def test_empty_state_matches_jax(name):
    """Every leaf float32 (Mamba's conv inputs in the compute dtype), of
    the reference's shape and value. The reference makes sLSTM's ``m`` in
    JAX's default float dtype, float64 once a test has enabled x64."""
    got = _torch_state(name, 3)
    want = _jax_state(name, 3)
    assert got.keys() == want.keys()
    for key in want:
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        assert got[key].dtype == torch.float32, key
        assert np.array_equal(got[key].numpy(), w), key
    if name != "mamba":
        assert bool(torch.isneginf(got["m"]).all())


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("start", ["empty", "random"])
def test_decode_steps_match_jax(name, start):
    """Five decode steps, from the empty state (``m = -inf``: the forget
    weight must come out 0, not NaN) or from a random one, outputs and
    states against the reference at each step."""
    jp, tp = _params(name)
    x = _x(name, 2, 5, seed=4)
    jstate = _jax_state(name, 2)
    if start == "random":
        rng = np.random.default_rng(5)
        jstate = {k: jnp.asarray(rng.standard_normal(v.shape).astype(
            np.asarray(v).dtype) * (0.5 if k != "m" else 1.0))
            for k, v in jstate.items()}
    tstate = _to_torch(jstate)
    step = _jax_decode(name)
    fn = getattr(ssm, f"{name}_apply_decode")
    for t in range(x.shape[1]):
        want, jstate = step(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        got, tstate = fn(tp, torch.from_numpy(x[:, t:t + 1]), tstate,
                         SPECS[name][1], torch.float32)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EXACT,
                                   atol=EXACT, err_msg=f"step {t}")
        _assert_states(tstate, jstate, EXACT, f"step {t}")


@pytest.mark.parametrize(
    "name,chunk", [(name, ssm.SCAN_CHUNK) for name in SPECS] + [("mamba", 4)])
def test_gradients_match_jax(monkeypatch, name, chunk):
    """d sum(y²) / d(every parameter and x) of the train form: finite and
    equal to the reference's at the forward's tolerance (Mamba also across
    chunks of 4 steps)."""
    monkeypatch.setattr(ssm, "SCAN_CHUNK", chunk)
    jspec, tspec = SPECS[name]
    jp, tp = _params(name, seed=2)
    x = _x(name, 2, 9, seed=3)
    jfn = getattr(jssm, f"{name}_apply_train")
    jg_p, jg_x = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jfn(p, xx, jspec, jnp.float32) ** 2),
        argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves, treedef = jax.tree.flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = getattr(ssm, f"{name}_apply_train")(
        jax.tree.unflatten(treedef, leaves), xt, tspec, torch.float32)
    grads = torch.autograd.grad((y**2).sum(), leaves + [xt])
    want = jax.tree.leaves(jg_p) + [jg_x]
    tol = ROUTE[name]
    for path, g, w in zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(jp)[0]] + ["x"], grads, want):
        assert bool(torch.isfinite(g).all()), path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol, err_msg=path)


@pytest.mark.parametrize("name", list(SPECS))
def test_bf16_matches_jax(name):
    """bf16 parameters and compute (Mamba's a_log stays float32 in both):
    the train form and three decode steps after it at 2e-2."""
    jp, tp = _params(name, jnp.bfloat16)
    if name == "mamba":
        assert jp["a_log"].dtype == jnp.float32
        assert tp["a_log"].dtype == torch.float32
        assert tp["in_proj"]["kernel"].dtype == torch.bfloat16
    x = _x(name, 2, 10, seed=7)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = _jax_train(name, jnp.bfloat16)(jp, jnp.asarray(x))
    got, tstate = getattr(ssm, f"{name}_prefill")(
        tp, torch.from_numpy(x[:, :7]), SPECS[name][1], torch.bfloat16)
    full = getattr(ssm, f"{name}_apply_train")(
        tp, torch.from_numpy(x), SPECS[name][1], torch.bfloat16)
    assert full.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(full), np.asarray(want, np.float32),
                               rtol=BF16, atol=BF16)
    step = _jax_decode(name, jnp.bfloat16)
    jstate = _jax_state(name, 2, jnp.bfloat16)
    for t in range(7):
        _, jstate = step(jp, jnp.asarray(x[:, t:t + 1]), jstate)
    fn = getattr(ssm, f"{name}_apply_decode")
    for t in range(7, 10):
        jout, jstate = step(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        out, tstate = fn(tp, torch.from_numpy(x[:, t:t + 1]), tstate,
                         SPECS[name][1], torch.bfloat16)
        np.testing.assert_allclose(_np(out), np.asarray(jout, np.float32),
                                   rtol=BF16, atol=BF16, err_msg=f"step {t}")


@pytest.mark.parametrize("name", list(SPECS))
def test_init_shapes_and_dtypes_match_jax(name):
    """The port's init on the CPU and on the meta device: the reference's
    leaves, shapes and dtypes (``lead`` stacks a leading axis)."""
    jspec, tspec = SPECS[name]
    for dtype, tdt in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        want = getattr(jssm, f"{name}_init")(jax.random.key(0), jspec, dtype)
        want = {jax.tree_util.keystr(p): (v.shape, str(v.dtype)) for p, v in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        for device, lead in (("cpu", ()), ("meta", (3,))):
            got = getattr(ssm, f"{name}_init")(
                torch.Generator().manual_seed(0) if device == "cpu" else None,
                tspec, tdt, device, lead)
            got = {jax.tree_util.keystr(p): (tuple(v.shape)[len(lead):],
                                             str(v.dtype).removeprefix("torch."))
                   for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
            assert got == want
