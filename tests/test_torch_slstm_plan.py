"""sLSTM's partition over a persistent cooperative grid
(`kernels/slstm_scan.plan`, `shared_bytes`, `hold_resident`) on the CPU.

The kernel itself runs only on the card (`chip_smoke.phase_recurrent_kernels`
holds it against its plain version at every case width); here the host
side that sizes and guards each launch: P x U covers d with no empty
group, P stays within the co-resident limit passed in, shared memory fits
Hopper's 227 KB a block in both dtypes and directions and equals the
.cu's layout written out by hand, and what the kernel cannot take is
refused before any launch.
"""

import pytest
import torch

from repro_torch.kernels import slstm_scan as slstm_mod

LIMIT = 132  # one block an SM of an H100
WIDTHS = (2, 12, 64, 100, 768, 1000, 1024)
DTYPES = (torch.float32, torch.bfloat16)


def _round_up(a, b):
    return -(-a // b) * b


def _layout_bytes(direction, dtype, d, u, rows):
    """The .cu's `fwd_layout` / `bwd_layout`, region by region."""
    warps, tile = 8, 16
    if direction == "forward" and dtype == torch.bfloat16:
        stride, cols = _round_up(d, 16) + 8, _round_up(4 * u, 8)
        r_part, x_part = 2 * cols * stride, 2 * tile * stride
    elif direction == "forward":
        cols = 4 * u
        r_part, x_part = 4 * d * cols, 4 * rows * _round_up(d, 8)
    elif dtype == torch.bfloat16:
        stride, cols = _round_up(4 * d, 16) + 8, 8
        r_part, x_part = 2 * 8 * stride, 2 * tile * stride
    else:
        cols = 8
        r_part, x_part = 4 * u * (4 * d + 4), 4 * rows * 4 * d
    # the partial sums: double in the bf16 backward (its exact sum)
    part = 8 if direction == "backward" and dtype == torch.bfloat16 else 4
    return r_part + x_part + part * warps * rows * cols


@pytest.mark.parametrize("direction", slstm_mod.DESIGNS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_plan_covers_d_within_the_limit(d, dtype, direction):
    p = slstm_mod.plan(d, dtype, direction, LIMIT)
    assert 1 <= p.units <= slstm_mod.MAX_UNITS
    assert p.blocks == -(-d // p.units) <= LIMIT
    assert p.blocks * p.units >= d            # every unit has a block
    assert (p.blocks - 1) * p.units < d       # no block without a unit
    assert p.shared_bytes <= slstm_mod.SHARED_LIMIT == 227 * 1024
    assert p.shared_bytes == slstm_mod.shared_bytes(direction, dtype, d,
                                                    p.units, p.rows)
    assert p.shared_bytes == _layout_bytes(direction, dtype, d, p.units,
                                           p.rows)
    assert p.shared_bytes % 16 == 0
    if dtype == torch.bfloat16:
        assert p.rows == slstm_mod.ROW_TILE    # the forward's mma M
    else:
        assert 1 <= p.rows <= slstm_mod.ROW_TILE
        if p.rows < slstm_mod.ROW_TILE:        # as many rows as fit
            assert slstm_mod.shared_bytes(direction, dtype, d, p.units,
                                          p.rows + 1) > slstm_mod.SHARED_LIMIT
    # the exchange buffer's rows: whole 16-byte chunks, every unit's place
    want = 4 * d if direction == "backward" else d
    assert p.exchange_stride >= want and p.exchange_stride - want < 8
    assert p.exchange_stride * dtype.itemsize % 16 == 0


@pytest.mark.parametrize("d, limit, units, blocks, last", [
    (768, LIMIT, 6, 128, 6),     # xLSTM-125M: the rule's U
    (768, 96, 8, 96, 8),         # U = 8, the plan measured against U = 6
    (1024, LIMIT, 8, 128, 8),    # MAX_D: the largest plan
    (1000, LIMIT, 8, 125, 8),
    (770, LIMIT, 6, 129, 2),     # the last group partial
    (100, LIMIT, 1, 100, 1),
    (12, 4, 3, 4, 3),
])
def test_plan_takes_the_fewest_units_that_fit(d, limit, units, blocks, last):
    p = slstm_mod.plan(d, torch.bfloat16, "forward", limit)
    assert (p.units, p.blocks) == (units, blocks)
    assert d - (p.blocks - 1) * p.units == last


@pytest.mark.parametrize("d, limit, match", [
    (767, LIMIT, "even d"),
    (3, LIMIT, "even d"),
    (0, LIMIT, "even d"),
    (1026, LIMIT, "even d"),
    (1024, 100, "co-resident"),   # 11 units a block: over MAX_UNITS
    (768, 95, "co-resident"),     # 9 units a block
    (64, 0, "at least one block"),
])
def test_plan_refuses_what_the_kernel_cannot_take(d, limit, match):
    for dtype in DTYPES:
        for direction in slstm_mod.DESIGNS:
            with pytest.raises(ValueError, match=match):
                slstm_mod.plan(d, dtype, direction, limit)


def test_plan_refuses_other_dtypes_and_directions():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        slstm_mod.plan(64, torch.float16, "forward", LIMIT)
    with pytest.raises(ValueError, match="direction"):
        slstm_mod.plan(64, torch.float32, "sideways", LIMIT)


@pytest.mark.parametrize("dtype", DTYPES)
def test_float32_rows_shrink_to_what_shared_memory_holds(dtype):
    """bf16 keeps 16 rows a tile everywhere; float32's backward at d 768 and
    1024 holds fewer (R's rows and the [rows, 4d] tile in float32)."""
    rows = {d: slstm_mod.plan(d, dtype, "backward", LIMIT).rows
            for d in (768, 1024)}
    if dtype == torch.bfloat16:
        assert rows == {768: 16, 1024: 16}
    else:
        assert rows == {768: 12, 1024: 6}
    assert slstm_mod.plan(1024, dtype, "forward", LIMIT).rows == 16


def test_hold_resident_raises_unless_the_grid_fits_at_once():
    """The wrapper's guard before a cooperative launch: the kernel's shared
    bytes are the plan's, and P blocks fit in (blocks an SM) x SMs."""
    p = slstm_mod.plan(768, torch.bfloat16, "forward", LIMIT)
    slstm_mod.hold_resident(p, "forward", p.shared_bytes, 1, 132)
    slstm_mod.hold_resident(p, "forward", p.shared_bytes, 2, 64)
    with pytest.raises(RuntimeError, match="co-resident"):
        slstm_mod.hold_resident(p, "forward", p.shared_bytes, 1, 127)
    with pytest.raises(RuntimeError, match="co-resident"):
        slstm_mod.hold_resident(p, "forward", p.shared_bytes, 0, 132)
    with pytest.raises(RuntimeError, match="shared bytes"):
        slstm_mod.hold_resident(p, "forward", p.shared_bytes + 16, 1, 132)
