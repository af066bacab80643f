"""The port's float32 flash_attention design ("ffma"), CPU side: its tile
table (what csrc/flash_attention_ffma.cu instantiates, mirrored by
``flash_mod.ffma_tile``) fits a block's shared memory at every head_dim,
and the plain version (which the wrapper takes for CPU tensors, and which
chip_smoke.py holds the kernel to on the card) agrees with the JAX
package's oracle and with its Pallas kernel in interpret mode at
chip_smoke.FLASH_FFMA_CASES, in float32, at every head_dim.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

FP32_TOL = 2e-5            # rtol = atol: the JAX package's (tests/test_kernels.py)
BLOCK_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper (227 KB)
SOURCE = (pathlib.Path(flash_mod.__file__).parent / "csrc"
          / "flash_attention_ffma.cu")

# chip_smoke.FLASH_FFMA_CASES: (b, h, kv, sq, sk, causal, window, softcap,
# layout), run at every head_dim.
FFMA_CASES = [
    (2, 14, 2, 1000, 1000, True, 256, 50.0, "model"),  # group 7
    (1, 4, 4, 129, 129, True, None, None, "model"),    # group 1
    (2, 7, 1, 77, 77, True, None, None, "dense"),      # group 7, S = 77
    (3, 2, 2, 1, 1, True, None, None, "model"),        # one token
    (1, 8, 2, 200, 333, False, None, None, "model"),   # Sq < Sk
    (1, 8, 8, 300, 129, False, None, None, "dense"),   # Sq > Sk
    (1, 4, 2, 100, 300, True, None, None, "model"),    # causal, Sq < Sk
    (2, 4, 1, 260, 100, False, 64, 30.0, "model"),     # rows with no key
    (1, 14, 2, 1000, 1000, True, None, None, "fused"),
    (1, 4, 2, 300, 100, True, None, 50.0, "dense"),    # causal, Sq > Sk
]


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
def test_ffma_tile_fits_a_block(head_dim):
    """64 query rows and 64-key tiles of 256 threads at every head_dim; Q,
    the K/V ring (two stages of each, one at head_dim 256) and P within the
    227 KB a block may use."""
    tile = flash_mod.ffma_tile(head_dim)
    assert (tile.bm, tile.bn, tile.threads) == (64, 64, 256)
    assert tile.slots == (2 if head_dim == 256 else 4)
    assert tile.smem_bytes <= BLOCK_SMEM_BYTES
    assert tile.threads * 16 == tile.bm * tile.bn  # a 4 x 4 tile of S each


def test_ffma_tile_mirrors_the_source():
    """The constants of csrc/flash_attention_ffma.cu, read as text, equal
    the wrapper's mirror, and its static_asserts (which nvcc checks against
    FfmaTile<D>::kSmem) name the bytes ffma_tile gives at every head_dim."""
    text = SOURCE.read_text()
    consts = dict(
        (name, int(value))
        for name, value in re.findall(r"constexpr int (k\w+) = (\d+);", text)
    )
    assert consts["kBM"] == flash_mod.FFMA_BM
    assert consts["kBN"] == flash_mod.FFMA_BN
    assert consts["kThreads"] == flash_mod.FFMA_THREADS
    assert consts["kPadKV"] == flash_mod.FFMA_PAD_KV
    assert consts["kPadP"] == flash_mod.FFMA_PAD_P
    assert consts["kSlotsD256"] == flash_mod.FFMA_SLOTS_D256
    assert consts["kSlots"] == flash_mod.FFMA_SLOTS
    asserted = {
        int(d): int(n)
        for d, n in re.findall(r"FfmaTile<(\d+)>::kSmem == (\d+)", text)
    }
    assert asserted == {d: flash_mod.ffma_tile(d).smem_bytes
                        for d in flash_mod.HEAD_DIMS}
    for d in flash_mod.HEAD_DIMS:
        assert f"case {d}: return launch<{d}>" in text


@pytest.mark.parametrize("head_dim", [8, 96, 512])
def test_ffma_tile_refuses_other_head_dims(head_dim):
    with pytest.raises(ValueError):
        flash_mod.ffma_tile(head_dim)


def _arrays(seed, b, h, kv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, sq, d)).astype(np.float32),
        rng.standard_normal((b, kv, sk, d)).astype(np.float32),
        rng.standard_normal((b, kv, sk, d)).astype(np.float32),
    )


def _torch_views(arrays, layout):
    """The [B, heads, S, D] arrays as the kernel would receive them:
    "dense", "model" ([B,S,H,D] storage, transposed views) or "fused"
    (slices of one [B,S,H+2KV,D] tensor)."""
    q, k, v = (torch.from_numpy(a) for a in arrays)
    if layout == "dense":
        return q, k, v
    if layout == "model":
        return tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                     for t in (q, k, v))
    h, kv = q.shape[1], k.shape[1]
    fused = torch.cat([q, k, v], dim=1).transpose(1, 2).contiguous()
    return (fused[:, :, :h].transpose(1, 2),
            fused[:, :, h:h + kv].transpose(1, 2),
            fused[:, :, h + kv:].transpose(1, 2))


def _keyless_rows(sq, sk, causal, window):
    """Query rows that no key may reach: zeros in the port, a uniform
    average of V in the JAX oracle (and in the Pallas kernel, for a row of
    a block that other rows keep live)."""
    rows = np.arange(sq)
    last = rows if causal else np.full(sq, sk - 1)
    first = rows - window + 1 if window else np.zeros(sq, int)
    return np.minimum(last, sk - 1) < np.maximum(first, 0)


def _held(case, head_dim, oracle):
    b, h, kv, sq, sk, causal, window, cap, layout = FFMA_CASES[case]
    arrays = _arrays(500 + 10 * case + head_dim, b, h, kv, sq, sk, head_dim)
    q, k, v = _torch_views(arrays, layout)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    assert got.shape == (b, h, sq, head_dim) and got.dtype == torch.float32
    jax_arrays = [jnp.asarray(a) for a in arrays]
    if oracle == "jax_ref":
        exp = jax_ref.flash_attention_ref(*jax_arrays, causal=causal,
                                          window=window, softcap=cap)
    else:  # one block over each whole sequence: any S divides it
        exp = pallas_flash(*jax_arrays, causal=causal, window=window,
                           softcap=cap, block_q=sq, block_k=sk,
                           interpret=True)
    keyless = _keyless_rows(sq, sk, causal, window)
    assert torch.count_nonzero(got[:, :, keyless]) == 0
    np.testing.assert_allclose(
        got[:, :, ~keyless].numpy(), np.asarray(exp)[:, :, ~keyless],
        rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("case", range(len(FFMA_CASES)))
def test_flash_plain_matches_jax_at_ffma_cases(case, head_dim):
    """The plain version against the JAX oracle in float32 at 2e-5; rows
    that no key reaches are zeros."""
    _held(case, head_dim, "jax_ref")


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("case", range(len(FFMA_CASES)))
def test_flash_plain_matches_pallas_at_ffma_cases(case, head_dim):
    """The plain version against the Pallas kernel in interpret mode (one
    block over each sequence, the size every S allows) in float32 at
    2e-5; rows that no key reaches are zeros."""
    _held(case, head_dim, "pallas_interpret")


def test_the_table_is_chip_smokes():
    """The CPU table is chip_smoke.FLASH_FFMA_CASES, the one the kernel is
    held to on the card."""
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert FFMA_CASES == chip_smoke.FLASH_FFMA_CASES
