"""The port's float32 decode_attention design ("ffma"), CPU side: its tile
(what csrc/decode_attention.cu instantiates, mirrored by
``decode_mod.tile_slots``), and the plain version (which the wrapper takes
for CPU tensors, and which chip_smoke.py holds the kernel to on the card)
against the JAX package's oracle at chip_smoke.DECODE_FFMA_CASES, every
head_dim, and against its Pallas kernel in interpret mode at head_dim 256
with the softcap, in float32 at 2e-5.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

FP32_TOL = 2e-5  # rtol = atol: the JAX package's (tests/test_kernels.py)
SOURCE = (pathlib.Path(decode_mod.__file__).parent / "csrc"
          / "decode_attention.cu")

# chip_smoke.DECODE_FFMA_CASES: (b, h, kv, s, d, length, softcap, layout),
# each shape at every head_dim, then Gemma2-2B's decode layer at its fp32
# serve_check depth.
FFMA_CASES = [
    (b, h, kv, s, d, length, cap, layout)
    for d in flash_mod.HEAD_DIMS
    for b, h, kv, s, length, cap, layout in (
        (2, 16, 1, 300, 300, None, "model"),          # group 16, length = S
        (3, 4, 4, 129, 1, None, "dense"),             # group 1, length 1
        (2, 14, 2, 1000, 999, 50.0, "model"),         # group 7, softcap 50
        (3, 14, 2, 1000, [0, 517, 1000], None, "model"),  # [B], a 0
        (2, 7, 1, 77, 77, None, "dense"),             # S = 77, no whole tile
        (2, 4, 2, 100, 0, None, "model"),             # length 0
    )
] + [
    (1, 8, 4, 4616, 256, 4616, 50.0, "model"),    # Gemma2-2B's decode layer
]


def _arrays(seed, b, h, kv, s, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, 1, d)).astype(np.float32),
        rng.standard_normal((b, kv, s, d)).astype(np.float32),
        rng.standard_normal((b, kv, s, d)).astype(np.float32),
    )


def _torch_views(arrays, layout):
    """The arrays as the kernel would receive them: "dense" [B, heads, S,
    D], or "model" ([B, S, heads, D] storage, transposed views)."""
    out = tuple(torch.from_numpy(a) for a in arrays)
    if layout == "dense":
        return out
    return tuple(t.transpose(1, 2).contiguous().transpose(1, 2) for t in out)


def _held(case, oracle):
    """The plain version at FFMA_CASES[case] against ``oracle(arrays,
    length, cap)``; rows of length 0 are zeros (the JAX oracle averages V
    there instead, so those rows are not compared)."""
    b, h, kv, s, d, length, cap, layout = FFMA_CASES[case]
    arrays = _arrays(600 + case, b, h, kv, s, d)
    n = (torch.tensor(length, dtype=torch.int32) if isinstance(length, list)
         else length)
    got = ops.decode_attention(*_torch_views(arrays, layout), n, softcap=cap)
    assert got.shape == (b, h, 1, d) and got.dtype == torch.float32
    exp = np.asarray(oracle(arrays, np.asarray(length, np.int32), cap))
    lengths = np.broadcast_to(np.asarray(length), (b,))
    empty = lengths == 0
    assert torch.count_nonzero(got[torch.from_numpy(empty)]) == 0
    np.testing.assert_allclose(got[torch.from_numpy(~empty)].numpy(),
                               exp[~empty], rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("case", range(len(FFMA_CASES)))
def test_decode_plain_matches_jax_at_ffma_cases(case):
    """The plain version against the JAX oracle in float32 at 2e-5."""
    _held(case, lambda arrays, length, cap: jax_ref.decode_attention_ref(
        *[jnp.asarray(a) for a in arrays], length, softcap=cap))


# (case of FFMA_CASES, block_k dividing its S): head_dim 256 with softcap 50,
# group 7 at length S - 1, and Gemma2-2B's decode layer.
PALLAS_CASES = [
    (FFMA_CASES.index((2, 14, 2, 1000, 256, 999, 50.0, "model")), 250),
    (len(FFMA_CASES) - 1, 1154),
]


@pytest.mark.parametrize("case,block_k", PALLAS_CASES)
def test_decode_plain_matches_pallas_at_d256_softcap(case, block_k):
    """The plain version against the Pallas kernel in interpret mode in
    float32 at 2e-5."""
    assert FFMA_CASES[case][3] % block_k == 0
    _held(case, lambda arrays, length, cap: pallas_decode(
        *[jnp.asarray(a) for a in arrays], length, softcap=cap,
        block_k=block_k, interpret=True))


def test_the_table_is_chip_smokes():
    """The CPU table is chip_smoke.DECODE_FFMA_CASES, the one the kernel is
    held to on the card."""
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert FFMA_CASES == chip_smoke.DECODE_FFMA_CASES


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
def test_ffma_tile_mirrors_the_source(head_dim):
    """tile_slots(float32, d) is what csrc/decode_attention.cu's constexpr
    tile lines, read as text, give at every head_dim: kTileD16 slots at
    head_dim 16, kTile at the others."""
    text = SOURCE.read_text()
    consts = dict(
        (name, int(value))
        for name, value in re.findall(r"constexpr int (kTile\w*) = (\d+);",
                                      text)
    )
    assert consts == {"kTileD16": decode_mod.FFMA_TILE_D16,
                      "kTile": decode_mod.FFMA_TILE}
    assert "T = D == 16 ? kTileD16 : kTile;" in text
    want = consts["kTileD16"] if head_dim == 16 else consts["kTile"]
    assert decode_mod.tile_slots(torch.float32, head_dim) == want
    assert f"case {head_dim}: return launch<{head_dim}>" in text
