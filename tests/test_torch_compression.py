"""Port `runtime/compression.py` against the JAX package: the same numpy
trees (float32 and bf16, with ties) through both packages' compressors.
top-k, int8 and error feedback are bitwise (indices, values, scales,
decodes, residuals, bytes); random-k draws other coordinates by design
(a torch generator) and is held by its properties: k distinct indices,
values rescaled by 1/fraction, unbiased over seeds, the same bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat as jcompat
from repro.runtime import compression as jc
from repro_torch.runtime import compression as tc


@pytest.fixture(autouse=True, scope="module")
def _x64():
    """float64 on in JAX for this file's tests (as in every port test),
    and back as it was after them."""
    was = jcompat.x64_enabled()
    jcompat.ensure_x64()
    yield
    jax.config.update("jax_enable_x64", was)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(seed, ties=False):
    """Two leaves ``a`` [1024] and ``b`` [32, 16] as float32 numpy; with
    ``ties`` drawn from a handful of magnitudes, so most are equal."""
    rng = np.random.default_rng(seed)
    if ties:
        draw = lambda shape: (rng.integers(-3, 4, shape) * 0.25).astype(
            np.float32)
    else:
        draw = lambda shape: rng.standard_normal(shape).astype(np.float32)
    return {"a": draw((1024,)), "b": draw((32, 16))}


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ({k: jnp.asarray(v).astype(jd) for k, v in arrays.items()},
            {k: torch.from_numpy(v).to(td) for k, v in arrays.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype == jnp.bfloat16 else x


def _assert_bitwise(j, t):
    a, b = _np(j), _np(t)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


CASES = [(s, d, ties) for s in range(3) for d in DTYPES
         for ties in (False, True)]


@pytest.mark.parametrize("seed,dtype,ties", CASES)
@pytest.mark.parametrize("fraction", [0.01, 0.1, 0.5])
def test_topk_is_bitwise_the_reference(seed, dtype, ties, fraction):
    jt, tt = _both(_arrays(seed, ties), dtype)
    jcomp = jc.topk_compress(jt, fraction)
    tcomp = tc.topk_compress(tt, fraction)
    assert tcomp.nbytes == jcomp.nbytes
    for (ji, jv, jshape, _), (ti, tv, tshape, tdt) in zip(
            jcomp.payload, tcomp.payload):
        assert ti.dtype == torch.int32 and tuple(tshape) == tuple(jshape)
        _assert_bitwise(ji, ti)     # the lower index first among ties
        _assert_bitwise(jv, tv)
        assert tv.dtype == tdt
    jd, td = jcomp.decode(), tcomp.decode()
    for k in jd:
        assert td[k].dtype == tt[k].dtype
        _assert_bitwise(jd[k], td[k])


def test_topk_keeps_largest():
    _, t = _both(_arrays(0), "float32")
    d = tc.topk_compress(t, fraction=0.1).decode()
    for key in t:
        orig, dec = t[key].numpy(), d[key].numpy()
        nz = dec != 0
        np.testing.assert_array_equal(dec[nz], orig[nz])
        assert abs(nz.mean() - 0.1) < 0.05
        assert np.abs(orig[nz]).min() >= np.abs(orig[~nz]).max()


@pytest.mark.parametrize("seed,dtype,ties", CASES)
def test_int8_is_bitwise_the_reference(seed, dtype, ties):
    jt, tt = _both(_arrays(seed, ties), dtype)
    jcomp, tcomp = jc.int8_compress(jt), tc.int8_compress(tt)
    assert tcomp.nbytes == jcomp.nbytes == sum(
        v.numel() + 4 for v in tt.values())
    for (jq, jscale, _), (tq, tscale, tdt) in zip(
            jcomp.payload, tcomp.payload):
        assert tq.dtype == torch.int8
        assert tscale.dtype == tdt      # the scale in the leaf's dtype
        _assert_bitwise(jq, tq)
        _assert_bitwise(jscale, tscale)
    jd, td = jcomp.decode(), tcomp.decode()
    for k in jd:
        assert td[k].dtype == tt[k].dtype
        _assert_bitwise(jd[k], td[k])


def test_int8_roundtrip_error_bounded():
    _, t = _both(_arrays(2), "float32")
    comp = tc.int8_compress(t)
    d = comp.decode()
    for (q, scale, _), key in zip(comp.payload, t):
        orig = t[key].numpy()
        err = np.abs(d[key].numpy() - orig).max()
        assert err <= np.abs(orig).max() / 127.0 + 1e-6
        assert err <= float(scale) / 2 * (1 + 1e-6)


def test_int8_rounds_half_to_even():
    x = {"a": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])}
    q = tc.int8_compress(x).payload[0][0]
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_randk_properties(dtype):
    jt, tt = _both(_arrays(4), dtype)
    fraction = 0.25
    jcomp = jc.randk_compress(jt, fraction, seed=3)
    tcomp = tc.randk_compress(tt, fraction, seed=3)
    assert tcomp.nbytes == jcomp.nbytes
    for (ji, _, _, _), (ti, tv, _, tdt), leaf in zip(
            jcomp.payload, tcomp.payload, tt.values()):
        flat = leaf.reshape(-1)
        assert ti.dtype == torch.int32 and ti.numel() == np.asarray(ji).size
        assert torch.unique(ti).numel() == ti.numel()   # distinct
        assert int(ti.min()) >= 0 and int(ti.max()) < flat.numel()
        assert tv.dtype == tdt
        torch.testing.assert_close(tv, flat[ti.long()] / fraction,
                                   rtol=0, atol=0)
    dec = tcomp.decode()
    for key, leaf in tt.items():
        assert dec[key].shape == leaf.shape and dec[key].dtype == leaf.dtype
    # reproducible in the seed, different across seeds
    again = tc.randk_compress(tt, fraction, seed=3)
    other = tc.randk_compress(tt, fraction, seed=4)
    assert torch.equal(again.payload[0][0], tcomp.payload[0][0])
    assert not torch.equal(other.payload[0][0], tcomp.payload[0][0])


def test_randk_unbiased():
    t = {"a": torch.ones(512)}
    est = np.zeros(512)
    reps = 64
    for s in range(reps):
        est += tc.randk_compress(t, 0.25, seed=s).decode()["a"].numpy()
    est /= reps
    assert abs(est.mean() - 1.0) < 0.15


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_error_feedback_is_bitwise_the_reference(dtype):
    arrays = _arrays(5)
    jt, tt = _both(arrays, dtype)
    jef, tef = jc.ErrorFeedback(), tc.ErrorFeedback()
    for step in range(3):
        jcomp = jef.step(jt, lambda t: jc.topk_compress(t, 0.1))
        tcomp = tef.step(tt, lambda t: tc.topk_compress(t, 0.1))
        assert tcomp.nbytes == jcomp.nbytes
        for k in jt:
            _assert_bitwise(jef.residual[k], tef.residual[k])
            _assert_bitwise(jcomp.decode()[k], tcomp.decode()[k])


def test_error_feedback_accumulates_residual():
    ef = tc.ErrorFeedback()
    g = {"a": torch.tensor([1.0, 0.1, 0.1, 0.1])}
    c1 = ef.step(g, lambda t: tc.topk_compress(t, 0.25))
    assert float(ef.residual["a"].abs().sum()) == pytest.approx(0.3)
    c2 = ef.step(g, lambda t: tc.topk_compress(t, 0.25))
    assert c2.nbytes == c1.nbytes


@pytest.mark.parametrize("method,kw", [
    ("none", {}), ("int8", {}), ("topk", {}), ("topk", {"fraction": 0.3}),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_compressed_kappa_is_the_reference(method, kw, dtype):
    jt, tt = _both(_arrays(3), dtype)
    assert tc.compressed_kappa(tt, method, **kw) == jc.compressed_kappa(
        jt, method, **kw)


def test_compressed_kappa_consistency():
    _, t = _both(_arrays(3), "float32")
    full = tc.compressed_kappa(t, "none")
    tk = tc.compressed_kappa(t, "topk", fraction=0.01)
    q8 = tc.compressed_kappa(t, "int8")
    assert tk < q8 < full
    with pytest.raises(ValueError):
        tc.compressed_kappa(t, "zstd")
