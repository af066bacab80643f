"""Mamba's selective scan: the launch's shape (`kernels/selective_scan.plan`,
`shared_bytes`, `hold_layout`) on the CPU.

The kernels run only on the card (`chip_smoke.phase_recurrent_kernels`
holds them against their plain versions at every case width); here the
host side that sizes and guards each launch: the lanes of a (row, channel)
hold its d_state states between them, every channel of every case width
has its lanes in exactly one block, shared memory fits Hopper's 227 KB a
block and equals the .cu's layout written out by hand, the backward's
partials of dB and dC are one slice a block and the fake branch allocates
exactly those, and what the kernel cannot take is refused before any
launch.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as scan_mod

CU = (pathlib.Path(scan_mod.__file__).parent / "csrc"
      / "selective_scan.cu").read_text()
# chip_smoke.SCAN_CASES' and SCAN_PLAN_CASES' widths, Jamba's layer (16 384)
# and a TP-local one
WIDTHS = (64, 96, 130, 200, 256, 300, 1000, 1024, 16384)
DTYPES = (torch.float32, torch.bfloat16)


def _cu_constant(name):
    """``constexpr int <name> = <value>;`` in the .cu."""
    found = re.findall(rf"constexpr int {name} = (\d+);", CU)
    assert len(found) == 1, name
    return int(found[0])


def _layout_bytes(direction, ds, channels, threads):
    """The .cu's `Layout<DS>`, region by region, in float32."""
    chunk = 16
    if direction == "forward":
        dt_u = 2 * chunk * 2 * channels       # two chunks of dt and u rows
        bc = 2 * chunk * 2 * ds               # two chunks of B and C rows
        return 4 * (dt_u + bc)
    rows = 2 * chunk * (3 * channels + 2 * ds)  # dt, u, dy, B, C
    decays = chunk * threads * 4                # a thread's 16 x 4 decays
    sums = chunk * (threads // 32) * 2 * ds     # the warps' dB, dC a step
    return 4 * (rows + decays + sums)


def test_constants_are_the_kernels():
    assert _cu_constant("kChunk") == scan_mod.CHUNK
    assert _cu_constant("kNs") == scan_mod.LANE_STATES
    assert _cu_constant("kFwdThreads") == scan_mod.FWD_THREADS
    assert _cu_constant("kBwdChannels") == scan_mod.BWD_CHANNELS
    assert "232448" in CU and scan_mod.SHARED_LIMIT == 227 * 1024


@pytest.mark.parametrize("direction", scan_mod.DESIGNS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ds", scan_mod.STATE_DIMS)
@pytest.mark.parametrize("di", WIDTHS)
def test_plan_covers_every_channel_once(di, ds, dtype, direction):
    b, s = 2, 37
    p = scan_mod.plan(b, s, di, ds, dtype, direction)
    assert p.lanes * scan_mod.LANE_STATES == ds
    assert p.threads == p.channels * p.lanes
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.grid == (-(-di // p.channels), b)
    # the kernels' map: block x, thread t (warp w, lane l) -> channel x·C +
    # w·(32 / L) + l % (32 / L), part l / (32 / L) of its states
    x, t = np.meshgrid(np.arange(p.grid[0]), np.arange(p.threads),
                       indexing="ij")
    per_warp = 32 // p.lanes
    channel = x * p.channels + (t // 32) * per_warp + (t % 32) % per_warp
    part = (t % 32) // per_warp
    live = channel < di
    seen = np.zeros((di, p.lanes), dtype=int)
    np.add.at(seen, (channel[live], part[live]), 1)
    assert (seen == 1).all()
    assert (~live).sum() < p.threads          # no block without a channel
    # a channel's lanes are in one warp: the y and du/ddt sums shuffle
    # among them
    assert 32 % p.lanes == 0
    assert ((channel // per_warp) == (x * p.channels // per_warp
                                      + t // 32)).all()
    assert p.shared_bytes <= scan_mod.SHARED_LIMIT
    assert p.shared_bytes == scan_mod.shared_bytes(direction, ds, p.channels,
                                                   p.threads)
    assert p.shared_bytes == _layout_bytes(direction, ds, p.channels,
                                           p.threads)
    assert p.shared_bytes % 16 == 0
    assert p.partials == (p.grid[0] if direction == "backward" else 0)


@pytest.mark.parametrize("ds, direction, lanes, channels, threads, smem", [
    (16, "forward", 4, 32, 128, 12_288),
    (4, "forward", 1, 128, 128, 33_792),
    (16, "backward", 4, 128, 512, 217_088),
    (4, "backward", 1, 128, 128, 84_992),
])
def test_plan_at_each_state_dim(ds, direction, lanes, channels, threads,
                                smem):
    p = scan_mod.plan(1, 2048, 16384, ds, torch.bfloat16, direction)
    assert (p.lanes, p.channels, p.threads, p.shared_bytes) == (
        lanes, channels, threads, smem)


def test_backward_partials_are_fewer():
    """At Jamba's layer 128 slices, half of the 64-channel blocks' 256."""
    p = scan_mod.plan(1, 2048, 16384, 16, torch.bfloat16, "backward")
    assert p.partials == 128 == -(-16384 // 64) // 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ds", scan_mod.STATE_DIMS)
def test_fake_branch_allocates_the_plans_partials(monkeypatch, dtype, ds):
    """What the backward's fake call allocates: du, ddt, the dA partials
    per row, the plan's dB/dC partials and dh0 — nothing else."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached a kernel launch")

    monkeypatch.setattr(scan_mod, "_library", refuse)
    b, s, di = 2, 45, 200
    shapes = []
    empty = torch.empty

    def spy(*args, **kwargs):
        shapes.append(tuple(args[0]))
        return empty(*args, **kwargs)

    with FakeTensorMode():
        f32 = dict(dtype=torch.float32, device="cuda")
        u = empty((b, s, di), dtype=dtype, device="cuda")
        dt = empty((b, s, di), **f32)
        a = empty((di, ds), **f32)
        bm, cm = (empty((b, s, ds), **f32) for _ in range(2))
        h0 = empty((b, di, ds), **f32)
        ck = empty((b, scan_mod.checkpoints(s), di, ds), **f32)
        monkeypatch.setattr(scan_mod.torch, "empty", spy)
        grads = scan_mod.selective_scan_bwd(u, dt, a, bm, cm, h0, ck,
                                            empty((b, s, di), **f32))
        monkeypatch.setattr(scan_mod.torch, "empty", empty)
    p = scan_mod.plan(b, s, di, ds, dtype, "backward")
    assert shapes == [(b, s, di), (b, s, di), (b, di, ds),
                      (p.partials, b, s, 2 * ds), (b, di, ds)]
    assert [tuple(g.shape) for g in grads] == [
        (b, s, di), (b, s, di), (di, ds), (b, s, ds), (b, s, ds),
        (b, di, ds)]
    assert scan_mod.launch_count() == 0


@pytest.mark.parametrize("ds", [0, 2, 8, 32])
def test_plan_refuses_other_state_dims(ds):
    for direction in scan_mod.DESIGNS:
        with pytest.raises(ValueError, match="d_state"):
            scan_mod.plan(1, 16, 64, ds, torch.float32, direction)


def test_plan_refuses_other_dtypes_directions_and_sizes():
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            scan_mod.plan(1, 16, 64, 16, dtype, "forward")
    with pytest.raises(ValueError, match="direction"):
        scan_mod.plan(1, 16, 64, 16, torch.float32, "sideways")
    with pytest.raises(ValueError, match="negative"):
        scan_mod.plan(1, -1, 64, 16, torch.float32, "backward")


def test_refused_before_any_launch(monkeypatch):
    """A d_state the kernel is not built for never reaches the library, on
    fake CUDA tensors (the dry run) as on real ones."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the library")

    monkeypatch.setattr(scan_mod, "_library", refuse)
    ops.reset_launch_count()
    with FakeTensorMode():
        f32 = dict(dtype=torch.float32, device="cuda")
        u = torch.empty((1, 4, 8), **f32)
        a = torch.empty((8, 8), **f32)
        bm = torch.empty((1, 4, 8), **f32)
        h0 = torch.empty((1, 8, 8), **f32)
        ck = torch.empty((1, 1, 8, 8), **f32)
        with pytest.raises(ValueError, match="d_state"):
            scan_mod.selective_scan_fwd(u, u, a, bm, bm)
        with pytest.raises(ValueError, match="d_state"):
            scan_mod.selective_scan_bwd(u, u, a, bm, bm, h0, ck, u)
    assert scan_mod.launch_count() == 0


def test_hold_layout_raises_unless_the_kernel_is_the_plan():
    p = scan_mod.plan(1, 2048, 16384, 16, torch.bfloat16, "backward")
    scan_mod.hold_layout(p, "backward", (4, 128, 512, 217_088))
    for wrong in [(4, 64, 256, 217_088), (4, 128, 512, 217_104),
                  (2, 128, 512, 217_088)]:
        with pytest.raises(RuntimeError, match="layout"):
            scan_mod.hold_layout(p, "backward", wrong)
