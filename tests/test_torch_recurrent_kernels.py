"""The port's recurrent kernels' plain versions and wrappers on the CPU:
Mamba's selective scan and sLSTM's recurrence (`kernels/ref.py`,
`kernels/selective_scan.py`, `kernels/slstm_scan.py`) and mLSTM's prefill
in blocks of query rows (`models/ssm.py`).

* each plain forward against the JAX package's mixer (the port's `ssm`
  entry points, whose scans are these plain versions on CPU tensors), and
  its last state against the reference's S decode steps;
* each plain backward against autograd of its plain forward, and — as
  the backward of an autograd Function over the plain forward, in the
  mixer where the card's `Scan` stands — against `jax.grad` of the
  reference's mixer, across ragged chunk edges; sLSTM's also at ties of
  its two `maximum`s, where autograd splits the gradient in halves;
* each wrapper's branch for fake CUDA tensors (the dry run): the launch's
  outputs, checkpoints and partials included, one fake call counted with
  its `work()` FLOPs, no launch;
* mLSTM's row blocks at several sizes that do not divide S.

Inputs are drawn with numpy from fixed seeds; the JAX side is jitted.
Tolerances (rtol = atol): `tests/test_torch_ssm.py`'s routes (Mamba 1e-4,
mLSTM 1e-3, sLSTM 2e-5); 1e-5 where two float32 plain versions of one
function meet (a backward against autograd of its forward: the same
products, summed in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.kernels import slstm_scan as slstm_mod
from repro_torch.models import ssm

MAMBA_ROUTE, MLSTM_ROUTE, SLSTM_ROUTE = 1e-4, 1e-3, 2e-5
PLAIN = 1e-5

# d_state 16 and d_conv 4 as Jamba's; d_model small.
MAMBA = (jssm.MambaSpec(d_model=8, d_state=16, d_conv=4, expand=2),
         ssm.MambaSpec(d_model=8, d_state=16, d_conv=4, expand=2))
SLSTM = (jssm.SLSTMSpec(d_model=12, num_heads=2),
         ssm.SLSTMSpec(d_model=12, num_heads=2))
MLSTM = (jssm.MLSTMSpec(d_model=16, num_heads=2),
         ssm.MLSTMSpec(d_model=16, num_heads=2))


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _params(init, spec, seed):
    jp = init(jax.random.key(seed), spec, jnp.float32)
    return jp, _to_torch(jp)


def _x(d, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got,
                   np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def _decode_states(name, spec, jp, x):
    """The reference's S decode steps from the empty state."""
    step = jax.jit(lambda p, xx, st: getattr(jssm, f"{name}_apply_decode")(
        p, xx, st, spec, jnp.float32))
    state = getattr(jssm, f"{name}_init_state")(x.shape[0], spec,
                                                jnp.float32)
    for t in range(x.shape[1]):
        _, state = step(jp, jnp.asarray(x[:, t:t + 1]), state)
    return state


def _scan_inputs(b, s, di, ds, seed, h0=True):
    """Float32 scan inputs as the mixer makes them: dt > 0 (a softplus),
    A < 0, and the gradients to run back."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    return {"u": f(b, s, di),
            "dt": torch.nn.functional.softplus(f(b, s, di)),
            "a": -torch.exp(f(di, ds) * 0.5),
            "bm": f(b, s, ds), "cm": f(b, s, ds),
            "h0": f(b, di, ds) if h0 else None,
            "dy": f(b, s, di), "dh_last": f(b, di, ds)}


# ---------------------------------------------------------------------------
# Plain forwards against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, seed: int, b: int, s: int):
    """The reference's train form and its state after S decode steps, on
    ``name``'s spec, parameters from ``seed`` and x from ``seed + s``."""
    jspec = {"mamba": MAMBA, "slstm": SLSTM, "mlstm": MLSTM}[name][0]
    jp = getattr(jssm, f"{name}_init")(jax.random.key(seed), jspec,
                                       jnp.float32)
    x = _x(jspec.d_model, b, s, seed=seed + s)
    want = jax.jit(lambda p, xx: getattr(jssm, f"{name}_apply_train")(
        p, xx, jspec, jnp.float32))(jp, jnp.asarray(x))
    return jp, x, want, _decode_states(name, jspec, jp, x)


@pytest.mark.parametrize("s,chunk", [(1, 256), (37, 16), (37, 5), (64, 16)])
def test_mamba_plain_scan_matches_jax(monkeypatch, s, chunk):
    """The mixer's output against `mamba_apply_train` and its last state
    against S decode steps, at d_state 16 across chunk edges."""
    monkeypatch.setattr(ssm, "SCAN_CHUNK", chunk)
    jp, x, want, jstate = _jax_run("mamba", 3, 2, s)
    got, state = ssm.mamba_prefill(_to_torch(jp), torch.from_numpy(x),
                                   MAMBA[1], torch.float32)
    _close(got, want, MAMBA_ROUTE)
    _close(state["ssm"], jstate["ssm"], MAMBA_ROUTE, "ssm")
    _close(state["conv"], jstate["conv"], MAMBA_ROUTE, "conv")


@pytest.mark.parametrize("s", [1, 33])
def test_slstm_plain_scan_matches_jax(s):
    jspec, tspec = SLSTM
    jp, tp = _params(jssm.slstm_init, jspec, 4)
    x = _x(jspec.d_model, 3, s, seed=10 + s)
    want = jax.jit(lambda p, xx: jssm.slstm_apply_train(
        p, xx, jspec, jnp.float32))(jp, jnp.asarray(x))
    got, state = ssm.slstm_prefill(tp, torch.from_numpy(x), tspec,
                                   torch.float32)
    _close(got, want, SLSTM_ROUTE)
    jstate = _decode_states("slstm", jspec, jp, x)
    for key in ("c", "n", "h", "m"):
        _close(state[key], jstate[key], SLSTM_ROUTE, key)


def test_slstm_step_is_the_decode_step():
    """`ref.slstm_step_ref` computes what `slstm_apply_decode`'s step does:
    the plain scan's steps and S decode steps give one carry, bitwise."""
    _, tspec = SLSTM
    _, tp = _params(jssm.slstm_init, SLSTM[0], 5)
    x = torch.from_numpy(_x(tspec.d_model, 2, 6, seed=6))
    _, carry = ssm.slstm_prefill(tp, x, tspec, torch.float32)
    state = ssm.slstm_init_state(2, tspec, "cpu")
    for t in range(x.shape[1]):
        _, state = ssm.slstm_apply_decode(tp, x[:, t:t + 1], state, tspec,
                                          torch.float32)
    for key in carry:
        assert torch.equal(carry[key], state[key]), key


# ---------------------------------------------------------------------------
# Plain backwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,h0", [(1, 256, True), (21, 5, True),
                                        (33, 16, False)])
def test_scan_bwd_ref_matches_autograd(s, chunk, h0):
    """`selective_scan_bwd_ref` against autograd of `selective_scan_ref`
    (both outputs' gradients given)."""
    inp = _scan_inputs(2, s, 6, 16, seed=20 + s, h0=h0)
    leaves = {k: inp[k].clone().requires_grad_(True)
              for k in ("u", "dt", "a", "bm", "cm")}
    h0_t = None if inp["h0"] is None else inp["h0"].clone().requires_grad_()
    y, h = ref.selective_scan_ref(**leaves, h0=h0_t, chunk=chunk)
    grads = torch.autograd.grad(
        (y * inp["dy"]).sum() + (h * inp["dh_last"]).sum(),
        list(leaves.values()) + ([h0_t] if h0 else []))
    got = ref.selective_scan_bwd_ref(
        inp["u"], inp["dt"], inp["a"], inp["bm"], inp["cm"], inp["h0"],
        inp["dy"], inp["dh_last"])
    names = ["du", "ddt", "da", "dbm", "dcm", "dh0"][:len(grads)]
    for name, g, w in zip(names, got, grads):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, PLAIN, name)


def _slstm_inputs(b, s, d, seed, r_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    carry = ssm.slstm_init_state(b, ssm.SLSTMSpec(d, 1), "cpu")
    return {"pre_x": f(b, s, 4 * d), "r": (f(d, 4 * d) * d**-0.5).to(r_dtype),
            "carry": carry, "dhs": f(b, s, d),
            "dlast": {"c": f(b, d), "n": f(b, d), "h": f(b, d), "m": f(b, d)}}


def _slstm_autograd(pre_x, r, carry, dhs, dlast):
    leaves = [pre_x.clone().requires_grad_(), r.clone().requires_grad_()]
    c0 = {k: v.clone().requires_grad_(k != "m" or bool(
        torch.isfinite(v).all())) for k, v in carry.items()}
    hs, last = ref.slstm_scan_ref(leaves[0], leaves[1], c0)
    loss = (hs * dhs).sum() + sum((last[k] * dlast[k]).sum() for k in last)
    wrt = leaves + [c0[k] for k in "cnhm" if c0[k].requires_grad]
    return torch.autograd.grad(loss, wrt, allow_unused=True)


@pytest.mark.parametrize("s,r_dtype", [(1, torch.float32),
                                       (17, torch.float32),
                                       (9, torch.bfloat16)])
def test_slstm_bwd_ref_matches_autograd(s, r_dtype):
    """`slstm_scan_bwd_ref` against autograd of `slstm_scan_ref` from the
    empty carry (m = -inf) and from a random one; in bf16 the recurrent
    products' gradients round as autograd's do."""
    inp = _slstm_inputs(2, s, 8, seed=30 + s, r_dtype=r_dtype)
    rng = np.random.default_rng(7)
    random = {k: torch.from_numpy(rng.standard_normal((2, 8)).astype(
        np.float32)) for k in "cnhm"}
    for carry in (inp["carry"], random):
        want = _slstm_autograd(inp["pre_x"], inp["r"], carry, inp["dhs"],
                               inp["dlast"])
        dpre, dcarry = ref.slstm_scan_bwd_ref(inp["pre_x"], inp["r"], carry,
                                              inp["dhs"], inp["dlast"])
        _close(dpre, want[0], PLAIN, "dpre")
        h_prev = torch.cat([carry["h"][:, None], ref.slstm_scan_ref(
            inp["pre_x"], inp["r"], carry)[0][:, :-1]], dim=1).to(r_dtype)
        dr = h_prev.reshape(-1, 8).T @ dpre.to(r_dtype).reshape(-1, 32)
        # autograd sums the S steps' products, each rounded to r's dtype
        tol = PLAIN if r_dtype == torch.float32 else 2e-2
        _close(dr.float(), want[1].float(), tol, "dr")
        finite_m = bool(torch.isfinite(carry["m"]).all())
        keys = "cnhm" if finite_m else "cnh"
        for key, w in zip(keys, want[2:]):
            _close(dcarry[key], w, PLAIN, key)


def test_bf16_once_rounds_once():
    """float64 → bfloat16 in one rounding, to nearest with ties to even:
    just above a midpoint rounds up where the cast through float32 lands
    on the midpoint and rounds to even; an exact midpoint goes to even;
    and over a wide spread no bfloat16 neighbour is nearer."""
    above = torch.tensor([1 + 2**-8 + 2**-30, -(1 + 2**-8 + 2**-30)],
                         dtype=torch.float64)
    assert ref._bf16_once(above).tolist() == [1 + 2**-7, -(1 + 2**-7)]
    assert above.to(torch.bfloat16).tolist() == [1.0, -1.0]
    ties = torch.tensor([1 + 2**-8, 1 + 3 * 2**-8], dtype=torch.float64)
    assert ref._bf16_once(ties).tolist() == [1.0, 1 + 2**-6]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(20000)
                         * np.exp(4 * rng.standard_normal(20000)))
    got = ref._bf16_once(x)
    bits = got.view(torch.int16)
    err = (got.double() - x).abs()
    for step in (1, -1):
        near = (bits + step).view(torch.bfloat16).double()
        assert not bool(((near - x).abs() < err).any())


@pytest.mark.parametrize("r_dtype", [torch.float32, torch.bfloat16])
def test_slstm_bwd_ref_exact_product(r_dtype):
    """`exact=True` sums each step's recurrent product in float64 before its
    one rounding to r's dtype (what the card's bf16 backward computes): the
    initial h's gradient is the once-rounded product of step 0's rounded
    dpre, and the whole backward stays with autograd's as the default
    product does (float32 at PLAIN, bf16 at its 2e-2)."""
    inp = _slstm_inputs(2, 9, 8, seed=47, r_dtype=r_dtype)
    rng = np.random.default_rng(8)
    carry = {k: torch.from_numpy(rng.standard_normal((2, 8)).astype(
        np.float32)) for k in "cnhm"}
    dpre, dcarry = ref.slstm_scan_bwd_ref(inp["pre_x"], inp["r"], carry,
                                          inp["dhs"], inp["dlast"],
                                          exact=True)
    total = dpre[:, 0].to(r_dtype).double() @ inp["r"].double().T
    want_h = (ref._bf16_once(total) if r_dtype == torch.bfloat16
              else total.to(r_dtype)).float()
    assert torch.equal(dcarry["h"], want_h)
    want = _slstm_autograd(inp["pre_x"], inp["r"], carry, inp["dhs"],
                           inp["dlast"])
    tol = PLAIN if r_dtype == torch.float32 else 2e-2
    _close(dpre, want[0], tol, "dpre")
    for key, w in zip("cnhm", want[2:]):
        _close(dcarry[key], w, tol, key)


def test_slstm_bwd_ref_from_saved_forward():
    """Given the forward's pre-activations and (c, n, m) as the kernel
    saves them, the reverse recurrence gives what it gives recomputing the
    forward from pre_x, bitwise."""
    inp = _slstm_inputs(2, 7, 8, seed=45, r_dtype=torch.bfloat16)
    pre, states, carry = [], [], inp["carry"]
    for t in range(7):
        pre.append(inp["pre_x"][:, t] + (carry["h"].to(torch.bfloat16)
                                         @ inp["r"]).float())
        carry = ref.slstm_step_ref(inp["pre_x"][:, t], inp["r"], carry)
        states.append(torch.stack([carry[k] for k in "cnm"]))
    saved = (torch.stack(pre, dim=1), torch.stack(states, dim=2))
    want = ref.slstm_scan_bwd_ref(inp["pre_x"], inp["r"], inp["carry"],
                                  inp["dhs"], inp["dlast"])
    got = ref.slstm_scan_bwd_ref(None, inp["r"], inp["carry"], inp["dhs"],
                                 inp["dlast"], saved=saved)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in "cnhm")


def test_slstm_bwd_ref_splits_ties_as_autograd():
    """Both `maximum`s tied at step 0: m' = max(logσ(f) + m, i) with
    logσ(200) = 0 = m = i, and n' = 1 + 2⁻²⁰ = exp(-m') + 1e-6 in float32;
    autograd gives each side half, and so must the reverse recurrence."""
    b, s, d = 1, 3, 4
    inp = _slstm_inputs(b, s, d, seed=40)
    pre_x = inp["pre_x"].clone()
    pre_x[:, 0, d:2 * d] = 0.0        # i
    pre_x[:, 0, 2 * d:3 * d] = 200.0  # f: logσ(200) = 0 exactly
    carry = {"c": torch.zeros(b, d), "n": torch.full((b, d), 2.0**-20),
             "h": torch.zeros(b, d), "m": torch.zeros(b, d)}
    new = ref.slstm_step_ref(pre_x[:, 0], inp["r"], carry)
    assert bool((new["m"] == 0).all())
    assert bool((new["n"] == torch.exp(-new["m"]) + 1e-6).all())
    want = _slstm_autograd(pre_x, inp["r"], carry, inp["dhs"], inp["dlast"])
    dpre, dcarry = ref.slstm_scan_bwd_ref(pre_x, inp["r"], carry, inp["dhs"],
                                          inp["dlast"])
    _close(dpre, want[0], PLAIN, "dpre")
    for key, w in zip("cnhm", want[2:]):
        _close(dcarry[key], w, PLAIN, key)
    # a rule that gave a tie all to one side would be refused
    assert not torch.allclose(dpre[:, 0, d:2 * d],
                              2 * dpre[:, 0, d:2 * d], atol=1e-3)


def _grads_through(fn, tp, x):
    leaves, treedef = jax.tree.flatten(tp)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(jax.tree.unflatten(treedef, leaves), xt)
    return torch.autograd.grad((y**2).sum(), leaves + [xt])


def _jax_grads(fn, jp, x):
    g_p, g_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(fn(p, xx) ** 2),
                                argnums=(0, 1)))(jp, jnp.asarray(x))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    return paths + ["x"], jax.tree.leaves(g_p) + [g_x]


class _PlainScan(torch.autograd.Function):
    """`selective_scan_ref` whose backward is `selective_scan_bwd_ref`:
    what `selective_scan.Scan` is on the card, with the plain versions."""

    @staticmethod
    def forward(ctx, u, dt, a, bm, cm, h0):
        ctx.save_for_backward(u, dt, a, bm, cm, h0)
        return ref.selective_scan_ref(u, dt, a, bm, cm, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        return ref.selective_scan_bwd_ref(*ctx.saved_tensors, dy, dh_last)


class _PlainSlstmScan(torch.autograd.Function):
    """`slstm_scan_ref` whose backward is `slstm_scan_bwd_ref`, then dR as
    one matrix product: what `slstm_scan.Scan` is on the card."""

    @staticmethod
    def forward(ctx, pre_x, r, c, n, h, m):
        hs, last = ref.slstm_scan_ref(pre_x, r,
                                      {"c": c, "n": n, "h": h, "m": m})
        ctx.save_for_backward(pre_x, r, c, n, h, m, hs)
        return hs, last["c"], last["n"], last["m"]

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm):
        pre_x, r, c, n, h, m, hs = ctx.saved_tensors
        dpre, dcarry = ref.slstm_scan_bwd_ref(
            pre_x, r, {"c": c, "n": n, "h": h, "m": m}, dhs,
            {"c": dc, "n": dn, "h": torch.zeros_like(dc), "m": dm})
        b, s, d = hs.shape
        h_prev = torch.cat([h[:, None], hs[:, :-1]], dim=1).to(r.dtype)
        dr = h_prev.reshape(-1, d).T @ dpre.to(r.dtype).reshape(-1, 4 * d)
        return (dpre, dr, *(dcarry[k] for k in "cnhm"))


@pytest.mark.parametrize("s", [7, 35])
def test_mamba_plain_backward_matches_jax_grad(monkeypatch, s):
    """The mixer's gradients with its scan's backward `selective_scan_bwd_ref`
    (as the card runs the backward kernel) against `jax.grad` of
    `mamba_apply_train`, at S across 16-step edges."""
    calls = []

    def card_form(u, dt, a, bm, cm, h0=None, *, chunk):
        calls.append(chunk)
        h0 = torch.zeros((u.shape[0], u.shape[2], a.shape[1]))
        return _PlainScan.apply(u, dt, a, bm, cm, h0)

    monkeypatch.setattr(ops, "selective_scan", card_form)
    jspec, tspec = MAMBA
    jp, tp = _params(jssm.mamba_init, jspec, 8)
    x = _x(jspec.d_model, 2, s, seed=50 + s)
    got = _grads_through(
        lambda p, xx: ssm.mamba_apply_train(p, xx, tspec, torch.float32),
        tp, x)
    assert calls == [ssm.SCAN_CHUNK]
    paths, want = _jax_grads(
        lambda p, xx: jssm.mamba_apply_train(p, xx, jspec, jnp.float32),
        jp, x)
    for path, g, w in zip(paths, got, want):
        _close(g, w, MAMBA_ROUTE, path)


@pytest.mark.parametrize("s", [1, 12])
def test_slstm_plain_backward_matches_jax_grad(monkeypatch, s):
    """The mixer's gradients with its recurrence's backward
    `slstm_scan_bwd_ref`, then dR as one matrix product (as the card runs
    the backward kernel), against `jax.grad` of `slstm_apply_train`."""
    real = ops.slstm_scan

    def card_form(pre_x, r, carry):
        hs, c, n, m = _PlainSlstmScan.apply(pre_x, r, *(carry[k]
                                                        for k in "cnhm"))
        return hs, {"c": c, "n": n, "h": hs[:, -1], "m": m}

    monkeypatch.setattr(ops, "slstm_scan", card_form)
    jspec, tspec = SLSTM
    jp, tp = _params(jssm.slstm_init, jspec, 9)
    x = _x(jspec.d_model, 2, s, seed=60 + s)
    got = _grads_through(
        lambda p, xx: ssm.slstm_apply_train(p, xx, tspec, torch.float32),
        tp, x)
    paths, want = _jax_grads(
        lambda p, xx: jssm.slstm_apply_train(p, xx, jspec, jnp.float32),
        jp, x)
    for path, g, w in zip(paths, got, want):
        _close(g, w, SLSTM_ROUTE, path)
    assert ops.slstm_scan is card_form and real is slstm_mod.slstm_scan


# ---------------------------------------------------------------------------
# The wrappers on CPU and fake CUDA tensors
# ---------------------------------------------------------------------------


def test_cpu_calls_take_the_plain_versions():
    """On CPU tensors the wrappers return their plain versions' values and
    count no launch; the kernels are registered in `ops`."""
    assert ops.KERNELS["selective_scan"] is scan_mod
    assert ops.KERNELS["slstm_scan"] is slstm_mod
    ops.reset_launch_count()
    inp = _scan_inputs(1, 9, 4, 4, seed=70)
    args = [inp[k] for k in ("u", "dt", "a", "bm", "cm", "h0")]
    got = ops.selective_scan(*args, chunk=4)
    want = ref.selective_scan_ref(*args, chunk=4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    sl = _slstm_inputs(2, 5, 8, seed=71)
    hs, last = ops.slstm_scan(sl["pre_x"], sl["r"], sl["carry"])
    hs_ref, last_ref = ref.slstm_scan_ref(sl["pre_x"], sl["r"], sl["carry"])
    assert torch.equal(hs, hs_ref)
    assert all(torch.equal(last[k], last_ref[k]) for k in last)
    assert ops.launch_count("selective_scan") == 0
    assert ops.launch_count("slstm_scan") == 0


@pytest.fixture
def nothing_launched(monkeypatch):
    """A launch would need the library: refuse it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached a kernel launch")

    for mod in (scan_mod, slstm_mod):
        monkeypatch.setattr(mod, "_library", refuse)
    ops.reset_launch_count()
    ops.reset_fake_calls()
    yield
    assert all(ops.launch_count(k) == 0 for k in ops.KERNELS)
    ops.reset_fake_calls()


class _Ctx:
    """What `torch.autograd.Function` hands `forward` and `backward`: the
    Functions are called directly, as autograd's engine cannot take fake
    CUDA tensors where torch has no CUDA (it can on the card's host, where
    the dry run runs them)."""

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_selective_scan_fake_branch(nothing_launched, dtype):
    """Inference: one forward call, no checkpoints. Training (`Scan`): the
    forward saves its checkpoints [B, ceil(S / 16), di, ds]; the backward
    gives every gradient from one fake call, its partials
    [plan(...).partials, B, S, 2·ds] summed (their shape is held in
    tests/test_torch_scan_plan.py)."""
    b, s, di, ds = 2, 100, 130, 16
    with FakeTensorMode():
        f32 = dict(dtype=torch.float32, device="cuda")
        u = torch.empty((b, s, di), dtype=dtype, device="cuda")
        dt = torch.empty((b, s, di), **f32)
        a = torch.empty((di, ds), **f32)
        bm, cm = (torch.empty((b, s, ds), **f32) for _ in range(2))
        h0 = torch.zeros((b, di, ds), **f32)
        y, h = ops.selective_scan(u, dt, a, bm, cm, chunk=7)
        assert y.shape == (b, s, di) and y.dtype == torch.float32
        assert h.shape == (b, di, ds) and y.device.type == "cuda"
        ctx = _Ctx()
        y, h = scan_mod.Scan.forward(ctx, u, dt, a, bm, cm, h0)
        ck = ctx.saved_tensors[-1]
        assert ck.shape == (b, 7, di, ds) and ck.dtype == torch.float32
        grads = scan_mod.Scan.backward(ctx, torch.empty_like(y),
                                       torch.empty_like(h))
        for g, t in zip(grads, (u, dt, a, bm, cm, h0)):
            assert g.shape == t.shape and g.dtype == t.dtype
            assert g.device.type == "cuda"
    assert scan_mod.fake_calls_by_design() == {"forward": 2, "backward": 1}
    assert scan_mod.launch_count_by_design() == {"forward": 0, "backward": 0}
    cells = b * s * di * ds
    assert scan_mod.fake_flops() == (2 * scan_mod.FWD_FLOPS * cells
                                     + scan_mod.BWD_FLOPS * cells)
    assert ops.fake_flops("selective_scan") == scan_mod.fake_flops()
    assert scan_mod.work(u, ds, "forward", True)["bytes"] == (
        scan_mod.work(u, ds)["bytes"] + b * 7 * di * ds * 4)
    # the one exponential a cell that the function needs, both directions
    assert scan_mod.work(u, ds)["exps"] == cells
    assert scan_mod.work(u, ds, "backward")["exps"] == cells


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slstm_scan_fake_branch(nothing_launched, dtype):
    """Inference: one forward call. Training (`Scan`): the forward saves
    each step's pre-activations [B, S, 4·d] and (c, n, m) [3, B, S, d];
    every gradient, dR in r's dtype, from one backward fake call."""
    b, s, d = 3, 50, 768
    with FakeTensorMode():
        pre_x = torch.empty((b, s, 4 * d), dtype=torch.float32, device="cuda")
        r = torch.empty((d, 4 * d), dtype=dtype, device="cuda")
        carry = ssm.slstm_init_state(b, ssm.SLSTMSpec(d, 4), "cuda")
        hs, last = ops.slstm_scan(pre_x, r, carry)
        assert hs.shape == (b, s, d) and hs.dtype == torch.float32
        assert set(last) == {"c", "n", "h", "m"}
        assert all(t.shape == (b, d) for t in last.values())
        ctx = _Ctx()
        hs, c, n, m = slstm_mod.Scan.forward(
            ctx, pre_x, r, *(carry[k] for k in "cnhm"))
        pre, states = ctx.saved_tensors[-2:]
        assert pre.shape == (b, s, 4 * d) and states.shape == (3, b, s, d)
        grads = slstm_mod.Scan.backward(ctx, torch.empty_like(hs),
                                        *(torch.empty_like(t)
                                          for t in (c, n, m)))
        assert grads[0].shape == pre_x.shape
        assert grads[1].shape == r.shape and grads[1].dtype == dtype
        assert all(g.shape == (b, d) for g in grads[2:])
    assert slstm_mod.fake_calls_by_design() == {"forward": 2, "backward": 1}
    assert slstm_mod.launch_count_by_design() == {"forward": 0,
                                                  "backward": 0}
    fwd = b * s * (2 * d * 4 * d + slstm_mod.FWD_CELL_FLOPS * d)
    bwd = b * s * (2 * d * 4 * d + slstm_mod.BWD_CELL_FLOPS * d)
    assert slstm_mod.fake_flops() == 2 * fwd + bwd
    assert ops.fake_flops("slstm_scan") == slstm_mod.fake_flops()
    for direction in ("forward", "backward"):
        assert slstm_mod.work(pre_x, r, direction)["product_flops"] == (
            b * s * 2 * d * 4 * d)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with FakeTensorMode():
        f32 = dict(dtype=torch.float32, device="cuda")
        u = torch.empty((1, 4, 8), **f32)
        a = torch.empty((8, 5), **f32)
        bm = torch.empty((1, 4, 5), **f32)
        with pytest.raises(ValueError, match="d_state"):
            scan_mod.selective_scan_fwd(u, u, a, bm, bm)
        with pytest.raises(TypeError, match="dt"):
            scan_mod.selective_scan_fwd(u, u.half(), a.narrow(1, 0, 4),
                                        bm.narrow(2, 0, 4),
                                        bm.narrow(2, 0, 4))
        d = 1025
        carry = ssm.slstm_init_state(1, ssm.SLSTMSpec(d, 1), "cuda")
        with pytest.raises(ValueError, match="even d"):
            slstm_mod.slstm_scan_fwd(torch.empty((1, 2, 4 * d), **f32),
                                     torch.empty((d, 4 * d), **f32), carry)
    # the launches take CUDA tensors only: no plain route hides in them
    inp = _scan_inputs(1, 5, 4, 4, seed=72)
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.selective_scan_bwd(
            *(inp[k] for k in ("u", "dt", "a", "bm", "cm", "h0")),
            ck=torch.zeros((1, 1, 4, 4)), dy=inp["dy"])
    sl = _slstm_inputs(1, 3, 8, seed=73)
    saved = (sl["pre_x"], torch.zeros((3, 1, 3, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        slstm_mod.slstm_scan_bwd(sl["r"], sl["carry"], sl["dhs"],
                                 saved=saved)
    with pytest.raises(ValueError, match="CUDA"):
        slstm_mod.slstm_scan_fwd(sl["pre_x"], sl["r"], sl["carry"])


# ---------------------------------------------------------------------------
# mLSTM's prefill in row blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 5, 16, 1024])
def test_mlstm_row_blocks_match_jax(monkeypatch, rows):
    """Output against `mlstm_apply_train` and the state against S decode
    steps, with S = 37 cut into blocks of `rows` query rows."""
    monkeypatch.setattr(ssm, "MLSTM_ROWS", rows)
    jp, x, want, jstate = _jax_run("mlstm", 11, 2, 37)
    got, state = ssm.mlstm_prefill(_to_torch(jp), torch.from_numpy(x),
                                   MLSTM[1], torch.float32)
    _close(got, want, MLSTM_ROUTE)
    for key in ("c", "n", "m"):
        _close(state[key], jstate[key], MLSTM_ROUTE, key)
