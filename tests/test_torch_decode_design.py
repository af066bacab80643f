"""The port's decode_attention designs, CPU side: which design serves which
(dtype, head_dim), how the cache is split into blocks (whole waves of the
resident blocks, every slot covered once), that the per-design launch
counters count no plain call, and the plain version (which the wrappers
take for CPU tensors, and which chip_smoke.py holds the bf16 "mma" kernel
to on the card) against the JAX package's oracle and its Pallas kernel in
interpret mode at the shapes that design takes on.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

BF16_TOL = 2e-2  # rtol = atol: the JAX package's own (tests/test_kernels.py)
SMS = 132        # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_design_table(dtype, head_dim):
    """bf16 goes to the tensor-core design at every head_dim, float32 to
    FFMA (no TF32); each design has its own source."""
    got = decode_mod.design(dtype, head_dim)
    assert got == ("mma" if dtype == torch.bfloat16 else "ffma")
    assert got in decode_mod.DESIGNS
    source, symbol = decode_mod.LIBRARIES[got]
    assert (source == "decode_attention_mma") == (got == "mma")
    assert symbol == f"repro_{source}"


@pytest.mark.parametrize("dtype,head_dim,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 128, TypeError),
    (torch.int32, 64, TypeError),
    (torch.bfloat16, 96, ValueError),
    (torch.float32, 512, ValueError),
    (torch.bfloat16, 8, ValueError),
])
def test_design_refuses_what_no_kernel_serves(dtype, head_dim, error):
    with pytest.raises(error):
        decode_mod.design(dtype, head_dim)


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
def test_tile_slots(head_dim):
    """mma: 32-slot tiles (a warp's step), 16 at head_dim 256; ffma: 32 (a
    block's step, 4 slots a warp), 64 at head_dim 16."""
    assert decode_mod.tile_slots(torch.bfloat16, head_dim) == (
        16 if head_dim == 256 else 32)
    assert decode_mod.tile_slots(torch.float32, head_dim) == (
        64 if head_dim == 16 else 32)


# (batch, kv_heads, S): the served step, DECODE_32K, chip_smoke's small
# table case and Gemma2-2B's decode layer.
PLAN_SHAPES = [(32, 2, 8256), (128, 2, 32768), (2, 2, 512), (2, 4, 8192)]


def _fill(blocks: int, wave: int) -> float:
    return blocks / (math.ceil(blocks / wave) * wave)


@pytest.mark.parametrize("blocks_per_sm", range(1, 9))
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_fills_whole_waves(shape, blocks_per_sm):
    """The fewest splits whose B·KV·splits blocks fill their last wave of
    SMS·blocks_per_sm blocks to WAVE_FILL, where the tiles allow one (at
    the served, DECODE_32K and Gemma2 shapes they always do); else the
    count whose last wave is fullest. Never more splits than tiles."""
    b, kv, s = shape
    tile = decode_mod.tile_slots(torch.bfloat16, 64)
    tiles, splits = decode_mod.split_plan(b, kv, s, SMS, blocks_per_sm, tile)
    wave = SMS * blocks_per_sm
    counts = range(1, min(tiles, decode_mod.MAX_SPLITS) + 1)
    assert splits in counts
    full = [n for n in counts if _fill(b * kv * n, wave) >= decode_mod.WAVE_FILL]
    if full:
        assert splits == full[0]
    else:
        assert _fill(b * kv * splits, wave) == max(
            _fill(b * kv * n, wave) for n in counts)
    assert bool(full) == (shape != (2, 2, 512))


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize(
    "b,kv,s,blocks_per_sm",
    [(32, 2, 8256, 4), (128, 2, 32768, 2), (1, 1, 1, 1), (3, 4, 700, 3),
     (1, 8, 64, 8), (600, 2, 100, 5), (2, 1, 4000, 7), (1, 1, 0, 4)],
)
def test_split_plan_covers_every_slot_once(b, kv, s, blocks_per_sm, tile):
    """Split i takes tiles [i·tiles//splits, (i+1)·tiles//splits), as both
    kernels compute it: the parts are non-empty, disjoint and cover the
    cache's slots [0, S) with the last tile's ragged edge."""
    tiles, splits = decode_mod.split_plan(b, kv, s, SMS, blocks_per_sm, tile)
    assert tiles == max(1, math.ceil(s / tile))
    covered = []
    for i in range(splits):
        lo, hi = i * tiles // splits, (i + 1) * tiles // splits
        assert lo < hi
        covered.extend(range(lo * tile, min(hi * tile, s)))
    assert covered == list(range(s))


def test_launch_count_by_design_counts_no_plain_call():
    """Per-design counters sum to the total and stay at 0 on the CPU, in
    both dtypes."""
    ops.reset_launch_count()
    rng = np.random.default_rng(13)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(rng.standard_normal((2, 4, 1, 64))).to(dt)
        k = torch.from_numpy(rng.standard_normal((2, 2, 40, 64))).to(dt)
        ops.decode_attention(q, k, k, 33)
    assert decode_mod.launch_count_by_design() == dict.fromkeys(
        decode_mod.DESIGNS, 0)
    assert decode_mod.launch_count() == ops.launch_count("decode_attention") == 0


# bf16 shapes the mma design takes on the card (chip_smoke.DECODE_MMA_CASES):
# (b, h, kv, s, d, length, softcap).
MMA_CASES = [
    (2, 16, 1, 300, 64, 300, None),     # group 16, length = S
    (3, 4, 4, 129, 64, 1, None),        # group 1, length 1
    (2, 14, 2, 1000, 64, 999, 50.0),    # group 7, softcap
    (2, 7, 1, 77, 64, 77, None),        # S = 77, no whole tile
    (1, 32, 2, 200, 128, 199, 50.0),    # group 16 at D = 128
] + [(2, 8, 2, 777, d, 700, None) for d in flash_mod.HEAD_DIMS]


def _arrays(seed, b, h, kv, s, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, 1, d)).astype(np.float32),
        rng.standard_normal((b, kv, s, d)).astype(np.float32),
        rng.standard_normal((b, kv, s, d)).astype(np.float32),
    )


@pytest.mark.parametrize("case", range(len(MMA_CASES)))
def test_decode_plain_matches_jax_at_mma_cases(case):
    """The plain version against the JAX oracle in bf16, at the tables'
    tolerance."""
    b, h, kv, s, d, length, cap = MMA_CASES[case]
    arrays = _arrays(400 + case, b, h, kv, s, d)
    got = ops.decode_attention(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in arrays], length,
        softcap=cap)
    exp = jax_ref.decode_attention_ref(
        *[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], length,
        softcap=cap)
    assert got.shape == (b, h, 1, d) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(exp, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("length", [1, 300, 512])
def test_decode_plain_matches_pallas_gemma2_layer(length):
    """Gemma2-2B's decode layer shape (8 heads, 4 KV heads, head_dim 256,
    softcap 50) in bf16 against the Pallas kernel in interpret mode."""
    arrays = _arrays(420 + length, 1, 8, 4, 512, 256)
    got = ops.decode_attention(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in arrays], length,
        softcap=50.0)
    exp = pallas_decode(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
                        length, softcap=50.0, block_k=256, interpret=True)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(exp, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
