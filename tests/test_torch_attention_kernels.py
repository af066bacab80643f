"""Port attention kernels, CPU side: the plain versions (which the wrappers
take for CPU tensors) against the JAX package's oracles and its Pallas
kernels in interpret mode, on the case tables of tests/test_kernels.py,
plus what the port accepts beyond them (any S, `length` as [B], length 0)
and what its wrappers refuse.

The CUDA kernels themselves run only on a GPU; `chip_smoke.py` holds them
against these same plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

FP32_TOL = 2e-5  # rtol = atol: the JAX package's own (tests/test_kernels.py)
BF16_TOL = 2e-2

# (b, h, kv, s, d, window, softcap, dtype) — tests/test_kernels.py
FLASH_CASES = [
    (2, 4, 2, 128, 64, None, None, "float32"),
    (1, 8, 4, 256, 64, 64, None, "float32"),
    (2, 4, 4, 128, 128, None, 50.0, "float32"),
    (1, 2, 1, 256, 32, 128, 30.0, "float32"),
    (1, 4, 2, 128, 64, None, None, "bfloat16"),
    (1, 4, 4, 128, 256, 96, None, "bfloat16"),
]
# (b, h, kv, s, d, length, softcap, dtype)
DECODE_CASES = [
    (2, 4, 2, 512, 64, 300, None, "float32"),
    (1, 8, 8, 1024, 128, 1024, None, "float32"),
    (3, 4, 1, 512, 32, 1, None, "float32"),
    (2, 4, 2, 512, 64, 511, 50.0, "bfloat16"),
]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, sq, d)).astype(np.float32),
        rng.standard_normal((b, kv, sk, d)).astype(np.float32),
        rng.standard_normal((b, kv, sk, d)).astype(np.float32),
    )


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays]


def _close(got, exp, dtype):
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(exp, np.float32),
        rtol=tol, atol=tol,
    )


@pytest.mark.parametrize("oracle", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_plain_matches_jax(case, oracle):
    b, h, kv, s, d, window, cap, dt = FLASH_CASES[case]
    arrays = _qkv(100 + case, b, h, kv, s, s, d)
    got = ops.flash_attention(*_torch(arrays, dt), window=window, softcap=cap)
    if oracle == "jax_ref":
        exp = jax_ref.flash_attention_ref(
            *_jax(arrays, dt), window=window, softcap=cap
        )
    else:
        exp = pallas_flash(*_jax(arrays, dt), window=window, softcap=cap,
                           block_q=64, block_k=64, interpret=True)
    assert got.shape == (b, h, s, d)
    _close(got, exp, dt)


@pytest.mark.parametrize("oracle", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_decode_plain_matches_jax(case, oracle):
    b, h, kv, s, d, length, cap, dt = DECODE_CASES[case]
    arrays = _qkv(200 + case, b, h, kv, 1, s, d)
    got = ops.decode_attention(*_torch(arrays, dt), length, softcap=cap)
    if oracle == "jax_ref":
        exp = jax_ref.decode_attention_ref(*_jax(arrays, dt), length,
                                           softcap=cap)
    else:
        exp = pallas_decode(*_jax(arrays, dt), length, softcap=cap,
                            block_k=256, interpret=True)
    assert got.shape == (b, h, 1, d)
    _close(got, exp, dt)


@pytest.mark.parametrize(
    "b,h,kv,s,d,window,cap",
    [(2, 14, 2, 100, 64, None, None),   # ragged S, a GQA group of 7
     (1, 4, 2, 77, 16, 20, 30.0),       # head_dim 16, window, softcap
     (1, 2, 1, 1, 32, None, None)],     # one token
)
def test_flash_plain_any_length(b, h, kv, s, d, window, cap):
    """Any S is accepted (the Pallas kernel needs S % block == 0)."""
    arrays = _qkv(s + d, b, h, kv, s, s, d)
    got = ops.flash_attention(*_torch(arrays, "float32"), window=window,
                              softcap=cap)
    exp = jax_ref.flash_attention_ref(*_jax(arrays, "float32"),
                                      window=window, softcap=cap)
    _close(got, exp, "float32")


def test_flash_plain_unequal_lengths_and_non_causal():
    """Sq != Sk aligns positions at the start, as the JAX oracle does."""
    arrays = _qkv(5, 1, 4, 2, 40, 70, 32)
    for causal in (True, False):
        got = ops.flash_attention(*_torch(arrays, "float32"), causal=causal)
        exp = jax_ref.flash_attention_ref(*_jax(arrays, "float32"),
                                          causal=causal)
        _close(got, exp, "float32")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_plain_length_vector_and_ragged_s(dt):
    """`length` as [B] with a ragged cache: row b sees slots < length[b]."""
    b, h, kv, s, d = 3, 14, 2, 300, 64
    arrays = _qkv(7, b, h, kv, 1, s, d)
    lengths = np.array([1, 173, 300], np.int32)
    got = ops.decode_attention(
        *_torch(arrays, dt), torch.from_numpy(lengths)
    )
    exp = jax_ref.decode_attention_ref(*_jax(arrays, dt), jnp.asarray(lengths))
    _close(got, exp, dt)
    for i, n in enumerate(lengths):   # row by row with a scalar length
        row = ops.decode_attention(
            *(t[i:i + 1] for t in _torch(arrays, dt)), int(n)
        )
        assert torch.equal(row, got[i:i + 1])


def test_decode_length_zero_gives_zeros_as_the_pallas_kernel():
    """Pinned by design: length 0 → zeros in both the plain version and
    the CUDA kernel, as the Pallas kernel returns; the JAX oracle averages
    V uniformly instead."""
    arrays = _qkv(8, 2, 4, 2, 1, 256, 64)
    got = ops.decode_attention(
        *_torch(arrays, "float32"), torch.tensor([0, 256], dtype=torch.int32)
    )
    assert torch.count_nonzero(got[0]) == 0
    pallas = pallas_decode(*_jax(arrays, "float32"), jnp.asarray([0, 256]),
                           block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=FP32_TOL, atol=FP32_TOL)
    oracle = jax_ref.decode_attention_ref(*_jax(arrays, "float32"), 0)
    assert float(np.abs(np.asarray(oracle)).max()) > 0.01


def test_flash_row_without_a_valid_key_gives_zeros():
    """A query row outside every key's reach (non-causal window with
    Sq > Sk) gives zeros, the same rule as decode's length 0."""
    q, k, v = _torch(_qkv(9, 1, 2, 1, 40, 8, 32), "float32")
    got = ops.flash_attention(q, k, v, causal=False, window=4)
    assert torch.count_nonzero(got[:, :, 11:]) == 0
    assert torch.count_nonzero(got[:, :, :11]) > 0


def test_strided_views_equal_contiguous():
    """The model hands [B, S, H, D] activations over as transposed views."""
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.standard_normal((2, 33, 14, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 33, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 33, 2, 64)).astype(np.float32))
    views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    dense = tuple(t.contiguous() for t in views)
    assert torch.equal(ops.flash_attention(*views),
                       ops.flash_attention(*dense))
    length = torch.tensor(20, dtype=torch.int32)
    assert torch.equal(
        ops.decode_attention(views[0][:, :, :1], *views[1:], length),
        ops.decode_attention(dense[0][:, :, :1], *dense[1:], length),
    )


@pytest.mark.parametrize(
    "case",
    ["head_dim", "dtype", "mixed_dtype", "kv_not_dividing", "d_stride",
     "window_zero", "softcap_zero", "length_int64", "length_shape",
     "decode_two_queries", "group_too_large", "length_float"],
)
def test_wrappers_reject_bad_operands(case):
    q = torch.zeros(2, 4, 8, 32)
    k = torch.zeros(2, 2, 8, 32)
    qd = torch.zeros(2, 4, 1, 32)
    n = torch.tensor(3, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if case == "head_dim":
            ops.flash_attention(q[..., :24], k[..., :24], k[..., :24])
        elif case == "dtype":
            ops.flash_attention(q.double(), k.double(), k.double())
        elif case == "mixed_dtype":
            ops.flash_attention(q, k.to(torch.bfloat16), k)
        elif case == "kv_not_dividing":
            ops.flash_attention(q, k[:, :1].expand(2, 3, 8, 32), k[:, :1].expand(2, 3, 8, 32))
        elif case == "d_stride":
            ops.flash_attention(q, torch.zeros(2, 2, 32, 8).transpose(2, 3), k)
        elif case == "window_zero":
            ops.flash_attention(q, k, k, window=0)
        elif case == "softcap_zero":
            ops.flash_attention(q, k, k, softcap=0.0)
        elif case == "length_int64":
            ops.decode_attention(qd, k, k, n.long())
        elif case == "length_shape":
            ops.decode_attention(qd, k, k, torch.zeros(3, dtype=torch.int32))
        elif case == "decode_two_queries":
            ops.decode_attention(q[:, :, :2], k, k, n)
        elif case == "group_too_large":
            ops.decode_attention(torch.zeros(2, 17, 1, 32),
                                 torch.zeros(2, 1, 8, 32),
                                 torch.zeros(2, 1, 8, 32), n)
        else:
            ops.decode_attention(qd, k, k, 3.0)


@pytest.mark.parametrize(
    "b,kv,s",
    [(32, 2, 8256), (128, 2, 32768), (1, 1, 1), (3, 4, 700), (1, 8, 64),
     (600, 2, 100)],
)
def test_decode_split_plan_covers_the_cache(b, kv, s):
    """The bf16 design's splits at head_dim 64 (32-slot tiles, one
    resident block per SM on 132 SMs) cut the cache's tiles into balanced
    parts that cover [0, S) exactly once and never outnumber the tiles; at
    the served and DECODE_32K shapes, 2 and 1 splits: 128 and 256 blocks,
    97 % of one and of two waves of 132."""
    tile = decode_mod.tile_slots(torch.bfloat16, 64)
    tiles, splits = decode_mod.split_plan(b, kv, s, sm_count=132,
                                          blocks_per_sm=1, tile=tile)
    assert tiles == max(1, -(-s // tile))
    assert 1 <= splits <= tiles
    bounds = [i * tiles // splits for i in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] * tile >= s
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    want = {(32, 2, 8256): 2, (128, 2, 32768): 1}.get((b, kv, s))
    assert want is None or splits == want  # the two shapes chip_smoke times


def test_launch_counters_count_no_plain_call():
    """The counters count kernel launches only: CPU calls leave them."""
    ops.reset_launch_count()
    q, k, v = _torch(_qkv(11, 1, 2, 1, 16, 16, 32), "float32")
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, :, :1], k, v, 16)
    assert {name: ops.launch_count(name) for name in ops.KERNELS} == {
        "mixing_sgd_combine": 0, "flash_attention": 0, "decode_attention": 0,
        "selective_scan": 0, "slstm_scan": 0,
    }
    with pytest.raises(KeyError):
        ops.launch_count("no_such_kernel")


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_design_table(dtype, head_dim):
    """bf16 at every head_dim goes to wgmma (the models' 64/128/256 and
    the smoke configs' 16/32); float32 everywhere to FFMA (no TF32). Each
    design has its own source."""
    want = {"float32": "ffma", "bfloat16": "wgmma"}[dtype]
    got = flash_mod.design(TORCH_DTYPE[dtype], head_dim)
    assert got == want and got in flash_mod.DESIGNS
    source, symbol = flash_mod.LIBRARIES[got]
    assert source == {"wgmma": "flash_attention_wgmma",
                      "ffma": "flash_attention_ffma"}[got]
    assert symbol == f"repro_{source}"


@pytest.mark.parametrize("dtype,head_dim,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 128, TypeError),
    (torch.bfloat16, 96, ValueError),
    (torch.float32, 512, ValueError),
])
def test_design_refuses_what_no_kernel_serves(dtype, head_dim, error):
    with pytest.raises(error):
        flash_mod.design(dtype, head_dim)


def _views():
    """[B, heads, S, D] bf16 operands as the kernels receive them:
    contiguous, the model's transposed [B, S, H, D] storage, slices of a
    fused [B, S, H + 2KV, D] projection, and size-1 batch/head/sequence
    dims (whose strides torch leaves free)."""
    bf16 = torch.bfloat16
    fused = torch.zeros(2, 37, 14 + 2 * 2, 128, dtype=bf16)
    fused256 = torch.zeros(2, 7, 8 + 2 * 4, 256, dtype=bf16)
    return {
        "contiguous": torch.zeros(2, 14, 37, 64, dtype=bf16),
        "model_layout": torch.zeros(3, 33, 14, 64, dtype=bf16).transpose(1, 2),
        "fused_q": fused[:, :, :14].transpose(1, 2),
        "fused_v": fused[:, :, 16:].transpose(1, 2),
        "batch_1": torch.zeros(1, 33, 2, 128, dtype=bf16).transpose(1, 2),
        "heads_1": torch.zeros(2, 1, 19, 64, dtype=bf16),
        "seq_1": torch.zeros(4, 1, 8, 64, dtype=bf16).transpose(1, 2),
        "all_1": torch.zeros(1, 1, 1, 128, dtype=bf16),
        "odd_strides": torch.zeros(4096, dtype=bf16).as_strided(
            (1, 2, 3, 64), (0, 1280, 192, 1), storage_offset=64),
        # head_dim 256 (Gemma2-2B): 512-byte rows
        "d256_contiguous": torch.zeros(2, 4, 9, 256, dtype=bf16),
        "d256_model_layout": torch.zeros(2, 9, 8, 256, dtype=bf16).transpose(1, 2),
        "d256_fused_k": fused256[:, :, 8:12].transpose(1, 2),
        "d256_batch_1": torch.zeros(1, 5, 4, 256, dtype=bf16).transpose(1, 2),
    }


VIEW_NAMES = ["contiguous", "model_layout", "fused_q", "fused_v", "batch_1",
              "heads_1", "seq_1", "all_1", "odd_strides", "d256_contiguous",
              "d256_model_layout", "d256_fused_k", "d256_batch_1"]


@pytest.mark.parametrize("name", VIEW_NAMES)
def test_tensor_map_strides_address_every_row(name):
    """data_ptr + s·st[0] + h·st[1] + b·st[2] is the address of
    t[b, h, s, 0] for every (b, h, s) of the 4-D map (D, S, heads, B), and
    every stride is a positive multiple of 16 bytes (a tensor map takes
    nothing else)."""
    t = _views()[name]
    strides = flash_mod.tensor_map_strides(t)
    b, h, sq, _ = t.shape
    assert len(strides) == 3
    assert all(st > 0 and st % 16 == 0 for st in strides)
    base = t.data_ptr()
    for bi in range(b):
        for hi in range(h):
            for si in range(sq):
                addr = base + si * strides[0] + hi * strides[1] + bi * strides[2]
                assert addr == t[bi, hi, si].data_ptr()


def test_tensor_map_strides_refuse_a_broadcast_dim():
    """A dim of size > 1 with stride 0 (an expanded tensor) cannot be
    described to TMA: refused, not silently re-strided."""
    k = torch.zeros(2, 1, 8, 64, dtype=torch.bfloat16).expand(2, 3, 8, 64)
    with pytest.raises(ValueError):
        flash_mod.tensor_map_strides(k)


# bf16 cases that the wgmma design serves on the card: (b, h, kv, sq, sk, d,
# causal, window, softcap)
WGMMA_PLAIN_CASES = [
    (1, 4, 2, 128, 128, 128, True, 32, 50.0),     # D = 128, window, softcap
    (2, 14, 2, 100, 100, 64, True, None, None),   # group 7, ragged S
    (1, 7, 1, 77, 77, 128, True, 20, 30.0),       # group 7, D = 128
    (1, 8, 2, 40, 70, 64, False, None, None),     # non-causal, Sq < Sk
    (1, 4, 4, 90, 33, 128, False, None, 30.0),    # non-causal, Sq > Sk
    # D = 256 (Gemma2-2B's width; 64-key tiles on the card)
    (1, 8, 4, 128, 128, 256, True, 48, 50.0),     # window with softcap
    (2, 8, 4, 100, 100, 256, True, None, 50.0),   # S not a multiple of 64
    (1, 4, 2, 64, 160, 256, False, None, 50.0),   # Sq < Sk
    (1, 4, 4, 192, 64, 256, False, 65, 30.0),     # rows 128.. see no key
    # D = 16 and 32 (the smoke configs' widths; 32- and 64-byte swizzle on
    # the card)
    (1, 8, 4, 128, 128, 16, True, 48, 50.0),      # window with softcap
    (1, 4, 2, 64, 160, 16, False, None, None),    # non-causal, Sq < Sk
    (2, 7, 1, 100, 100, 16, True, None, None),    # ragged S, group 7
    (1, 4, 4, 192, 64, 16, False, 65, 30.0),      # rows 128.. see no key
    (1, 8, 4, 128, 128, 32, True, 48, 50.0),      # window with softcap
    (1, 4, 2, 64, 160, 32, False, None, None),    # non-causal, Sq < Sk
    (2, 7, 1, 100, 100, 32, True, None, None),    # ragged S, group 7
    (1, 4, 4, 192, 64, 32, False, 65, 30.0),      # rows 128.. see no key
]
D256_CASES = range(5, 9)
SMALL_D_CASES = range(9, 17)
# The Pallas kernel's blocks per case (it needs S % block == 0), chosen
# so that every key-less row lies in a whole query block (which the kernel
# skips, giving zeros as the port does).
PALLAS_BLOCKS = {100: 50, 128: 64, 64: 64, 160: 32, 192: 64, 77: 77,
                 40: 40, 70: 35, 90: 45, 33: 33}


def _keyless_rows(sq, sk, causal, window):
    """Query rows that no key may reach: zeros in the port and the Pallas
    kernel, a uniform average of V in the JAX oracle."""
    rows = np.arange(sq)
    last = rows if causal else np.full(sq, sk - 1)
    first = rows - window + 1 if window else np.zeros(sq, int)
    return (np.minimum(last, sk - 1) < np.maximum(first, 0))


@pytest.mark.parametrize("case", range(len(WGMMA_PLAIN_CASES)))
def test_flash_plain_matches_jax_at_wgmma_cases(case):
    """The plain version (what the card's kernel is held to) against the
    JAX oracle in bf16 at the shapes the new design takes on; rows that no
    key reaches are zeros (the oracle averages V there)."""
    b, h, kv, sq, sk, d, causal, window, cap = WGMMA_PLAIN_CASES[case]
    arrays = _qkv(300 + case, b, h, kv, sq, sk, d)
    got = ops.flash_attention(*_torch(arrays, "bfloat16"), causal=causal,
                              window=window, softcap=cap)
    exp = jax_ref.flash_attention_ref(*_jax(arrays, "bfloat16"),
                                      causal=causal, window=window,
                                      softcap=cap)
    assert got.shape == (b, h, sq, d)
    keyless = _keyless_rows(sq, sk, causal, window)
    assert torch.count_nonzero(got[:, :, keyless]) == 0
    _close(got[:, :, ~keyless], np.asarray(exp, np.float32)[:, :, ~keyless],
           "bfloat16")


def _held_to_pallas(case):
    b, h, kv, sq, sk, d, causal, window, cap = WGMMA_PLAIN_CASES[case]
    arrays = _qkv(300 + case, b, h, kv, sq, sk, d)
    got = ops.flash_attention(*_torch(arrays, "bfloat16"), causal=causal,
                              window=window, softcap=cap)
    exp = pallas_flash(*_jax(arrays, "bfloat16"), causal=causal,
                       window=window, softcap=cap, block_q=PALLAS_BLOCKS[sq],
                       block_k=PALLAS_BLOCKS[sk], interpret=True)
    _close(got, exp, "bfloat16")


@pytest.mark.parametrize("case", D256_CASES)
def test_flash_plain_matches_pallas_at_wgmma_head_dim_256(case):
    """The D = 256 cases against the Pallas kernel in interpret mode at
    the JAX package's bf16 tolerance, key-less rows included."""
    _held_to_pallas(case)


@pytest.mark.parametrize("case", SMALL_D_CASES)
def test_flash_plain_matches_pallas_at_wgmma_head_dim_16_32(case):
    """The D = 16 and 32 cases (window with softcap, non-causal Sq < Sk,
    ragged S, key-less rows) against the Pallas kernel in interpret mode
    at the JAX package's bf16 tolerance."""
    _held_to_pallas(case)


def test_flash_plain_matches_pallas_at_head_dim_128_bf16():
    """D = 128 with window and softcap in bf16, against the Pallas kernel
    in interpret mode (S divisible by its blocks)."""
    arrays = _qkv(310, 1, 4, 2, 128, 128, 128)
    got = ops.flash_attention(*_torch(arrays, "bfloat16"), window=48,
                              softcap=50.0)
    exp = pallas_flash(*_jax(arrays, "bfloat16"), window=48, softcap=50.0,
                       block_q=64, block_k=64, interpret=True)
    _close(got, exp, "bfloat16")


def test_launch_count_by_design_counts_no_plain_call():
    """Per-design counters sum to the total and stay at 0 on the CPU."""
    ops.reset_launch_count()
    q, k, v = _torch(_qkv(12, 1, 2, 1, 16, 16, 64), "bfloat16")
    ops.flash_attention(q, k, v)
    assert flash_mod.launch_count_by_design() == dict.fromkeys(
        flash_mod.DESIGNS, 0)
    assert flash_mod.launch_count() == 0


@pytest.mark.parametrize("oracle", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_decode_plain_float32_head_dim_256(cap, oracle):
    """float32 at head_dim 256, the shape whose two 64-slot stages did not
    fit a block's shared memory on the card (now 32-slot tiles there), held
    to the float32 tolerance on the CPU side."""
    arrays = _qkv(320, 1, 8, 4, 1, 1024, 256)
    got = ops.decode_attention(*_torch(arrays, "float32"), 777, softcap=cap)
    if oracle == "jax_ref":
        exp = jax_ref.decode_attention_ref(*_jax(arrays, "float32"), 777,
                                           softcap=cap)
    else:
        exp = pallas_decode(*_jax(arrays, "float32"), 777, softcap=cap,
                            block_k=256, interpret=True)
    _close(got, exp, "float32")
