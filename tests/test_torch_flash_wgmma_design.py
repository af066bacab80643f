"""The port's bfloat16 flash_attention design ("wgmma"), CPU side: its tile
table (what csrc/flash_attention_wgmma.cu instantiates as ``Cfg<D>``,
mirrored by ``flash_mod.wgmma_tile``) at every head_dim. Rows are swizzled
at their own width (32, 64 or 128 bytes), so a TMA box must not be wider
than its swizzle span, and Q with the K/V ring must fit a block's shared
memory. The kernel itself, and its agreement with the plain version, are
held on the card by chip_smoke.py.
"""

import pathlib
import re

import pytest
import torch

from repro_torch.kernels import flash_attention as flash_mod

BLOCK_SMEM_BYTES = 232_448  # shared memory one block may use on Hopper (227 KB)
SOURCE = (pathlib.Path(flash_mod.__file__).parent / "csrc"
          / "flash_attention_wgmma.cu")
# The static_asserts that nvcc checks against Cfg<D>, read as text.
TABLE_LINE = re.compile(
    r"static_assert\(Cfg<(\d+)>::BN == (\d+) && Cfg<\d+>::kStages == (\d+) &&"
    r"\s*Cfg<\d+>::kRowBytes == (\d+) && Cfg<\d+>::kSmem == (\d+),")


def _table():
    return {int(d): tuple(int(x) for x in rest)
            for d, *rest in TABLE_LINE.findall(SOURCE.read_text())}


def test_the_source_asserts_a_tile_at_every_head_dim():
    assert sorted(_table()) == list(flash_mod.HEAD_DIMS)


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
def test_wgmma_tile_mirrors_the_source(head_dim):
    """Keys a tile, ring stages, swizzle bytes and shared memory of
    ``Cfg<D>`` (its static_asserts) equal ``wgmma_tile(D)``."""
    tile = flash_mod.wgmma_tile(head_dim)
    assert _table()[head_dim] == (tile.bn, tile.stages, tile.swizzle_bytes,
                                  tile.smem_bytes)


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
def test_wgmma_tile_fits_a_block_and_its_swizzle(head_dim):
    """Q and the ring within the 227 KB a block may use; a TMA box's inner
    extent (one column atom, 2 bytes a column) within the swizzle span,
    which is 32, 64 or 128 bytes; the row's column atoms cover D."""
    tile = flash_mod.wgmma_tile(head_dim)
    assert tile.smem_bytes <= BLOCK_SMEM_BYTES
    assert tile.swizzle_bytes in (32, 64, 128)
    assert 2 * tile.box_cols <= tile.swizzle_bytes
    assert head_dim % tile.box_cols == 0
    assert tile.swizzle_bytes == min(2 * head_dim, 128)
    assert tile.bm == 128 and tile.bn in (64, 128)
    assert tile.threads == (256 if head_dim == 256 else 384)


@pytest.mark.parametrize("head_dim", flash_mod.HEAD_DIMS)
def test_every_head_dim_is_launched(head_dim):
    """The C entry point takes and dispatches every head_dim the wrapper
    sends it."""
    text = SOURCE.read_text()
    assert f"return launch<{head_dim}>(q, k, v, tma_strides, p, batch, s);" \
        in text
    assert f"head_dim != {head_dim}" in text
    assert flash_mod.design(torch.bfloat16, head_dim) == "wgmma"


@pytest.mark.parametrize("head_dim", [8, 96, 512])
def test_wgmma_tile_refuses_other_head_dims(head_dim):
    with pytest.raises(ValueError):
        flash_mod.wgmma_tile(head_dim)
