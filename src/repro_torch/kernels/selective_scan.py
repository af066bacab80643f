"""Mamba's selective scan, forward and backward, on Hopper.

Replaces no TPU kernel: the JAX package scans with XLA
(``jax.lax.associative_scan``). For each row, channel d and state n,

    h_t[n] = exp(dt_t·A[d, n])·h_{t-1}[n] + (dt_t·B_t[n])·u_t
    y_t    = Σ_n h_t[n]·C_t[n]

over ``u [B, S, di]`` (the compute dtype), float32 ``dt [B, S, di]``,
``a [di, ds]``, ``bm``/``cm [B, S, ds]`` and ``h0 [B, di, ds]``, one
launch a layer (``csrc/selective_scan.cu``; ``ds`` ∈ {4, 16}, the
repo's configs' d_state).

The design splits each (row, channel)'s ``ds`` states over ``ds / 4``
lanes of one warp, four states a lane, so that enough warps are resident
to hide the recurrence's latency; a block stages a chunk of ``CHUNK``
steps' rows in shared memory. Thread ``t`` of block ``x`` holds channel
``x·channels + (t // 32)·(32 / lanes) + (t % 32) % (32 / lanes)`` and
part ``(t % 32) // (32 / lanes)`` of its states. ``plan`` is the launch's
shape on the host — lanes, channels and threads a block, the grid, the
shared bytes and the backward's partials of dB and dC — and the
launchers size their grids from it: before the first launch of a
(direction, ds) the wrapper reads the kernel's own layout
(``repro_selective_scan_layout``) and raises where the two differ
(``hold_layout``); the launcher refuses a plan that is not its layout
too. Three entry points:

* ``selective_scan(u, dt, a, bm, cm, h0=None, chunk=)`` → (``y [B, S,
  di]``, the last ``h``), float32: what ``models/ssm.mamba_prefill`` calls.
  When a gradient is wanted on a CUDA tensor it goes through ``Scan``, a
  ``torch.autograd.Function`` whose forward saves checkpoints of ``h``
  every ``CHUNK`` steps and whose backward is the backward kernel;
* ``selective_scan_fwd(...)`` → (y, last h, checkpoints or None): one
  forward launch;
* ``selective_scan_bwd(...)`` → (du, ddt, da, dbm, dcm, dh0): one
  backward launch, then the sums of its per-block partials.

On the CPU ``selective_scan`` is the plain version in ``kernels/ref.py``
(``selective_scan_ref`` in chunks of ``chunk`` steps, differentiated by
autograd; ``selective_scan_bwd_ref`` is the backward kernel's plain
version); a CUDA tensor launches the kernel or raises (also when the build
fails). Every launch adds one to
``launch_count()`` and to its direction's entry of
``launch_count_by_design()``. A fake CUDA tensor (``compat.is_fake``, the
dry run) gets what the launch allocates, the checkpoints and partials
included, and launches nothing: the call adds one to
``fake_calls_by_design()`` and its FLOPs (``work``) to ``fake_flops()``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

DESIGNS = ("forward", "backward")
STATE_DIMS = (4, 16)
# Steps between the forward's checkpoints of h, the chunk both kernels
# stage (kChunk in the .cu); states a lane (kNs); threads a forward block
# (kFwdThreads); channels a backward block (kBwdChannels): the backward
# writes one partial of dB and dC a block of channels.
CHUNK = 16
LANE_STATES = 4
FWD_THREADS = 128
BWD_CHANNELS = 128
SHARED_LIMIT = 232_448  # shared bytes a block can have on Hopper (227 KB)
# FLOPs a (token, channel, state): the forward's dt·A, dt·B, ·u, the
# update's multiply-add and the output's (7); the backward's recomputed
# state (5), its reverse walk (18, the .cu's loop body) and the sums of dB
# and dC over channels (2).
FWD_FLOPS, BWD_FLOPS = 7, 25
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DIRECTION_CODE = {"forward": 0, "backward": 1}

_launches = dict.fromkeys(DESIGNS, 0)
# Calls on fake tensors (the dry run), by direction, and the FLOPs they
# stand for; none of them launched anything.
_fake = {"calls": dict.fromkeys(DESIGNS, 0), "flops": 0}
_bound: dict[str, object] = {}
_layouts: dict[tuple[str, int], tuple[int, int, int, int]] = {}


def launch_count() -> int:
    """Kernel launches made by this module's wrappers so far."""
    return sum(_launches.values())


def launch_count_by_design() -> dict[str, int]:
    """Launches so far of the forward and of the backward kernel."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def fake_calls_by_design() -> dict[str, int]:
    """Calls on fake tensors so far (``compat.is_fake``), none of which
    launched, by direction."""
    return dict(_fake["calls"])


def fake_flops() -> int:
    """The FLOPs (``work``) that those calls stand for."""
    return _fake["flops"]


def reset_fake_calls() -> None:
    for name in _fake["calls"]:
        _fake["calls"][name] = 0
    _fake["flops"] = 0


def checkpoints(s: int) -> int:
    """Checkpoints of h the forward saves over ``s`` steps."""
    return -(-s // CHUNK)


def work(u: torch.Tensor, ds: int, direction: str = "forward",
         saved: bool = False) -> dict:
    """``{"flops", "exps", "bytes"}`` of one launch on ``u [B, S, di]``
    with ``ds`` states: ``FWD_FLOPS`` / ``BWD_FLOPS`` a (token, channel,
    state) and the one exponential there that the function needs (the
    backward kernel takes a second, recomputing the decay: not counted);
    each input read once and each output written
    once — forward: u, dt, B, C, A, h0 in, y and the last h out (and the
    checkpoints when ``saved``); backward: u, dt, dy, B, C, A, the
    checkpoints and the last h's gradient in, du, ddt, dB, dC, dA, dh0
    out."""
    b, s, di = u.shape
    cells = b * s * di * ds
    state = b * di * ds * 4
    rows = b * s * 2 * ds * 4                 # B and C (or dB and dC)
    if direction == "forward":
        moved = (b * s * di * (u.element_size() + 4 + 4) + rows
                 + di * ds * 4 + 2 * state)
        if saved:
            moved += b * checkpoints(s) * di * ds * 4
        return {"flops": FWD_FLOPS * cells, "exps": cells, "bytes": moved}
    moved = (b * s * di * (u.element_size() + 4 * 4) + 2 * rows
             + 2 * di * ds * 4 + 2 * state + b * checkpoints(s) * di * ds * 4)
    return {"flops": BWD_FLOPS * cells, "exps": cells, "bytes": moved}


# ---------------------------------------------------------------------------
# The plan: lanes, channels and threads a block, grid, shared bytes, partials
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape: ``lanes`` lanes of one warp a (row, channel),
    ``LANE_STATES`` states each; ``channels`` channels and ``threads``
    threads a block; the grid ``(⌈di / channels⌉, B)``; ``shared_bytes``
    of shared memory a block; and, in the backward, ``partials`` slices of
    dB and dC (``[partials, B, S, 2·ds]``, one a block of channels; 0 in
    the forward)."""
    lanes: int
    channels: int
    threads: int
    grid: tuple[int, int]
    shared_bytes: int
    partials: int


def shared_bytes(direction: str, ds: int, channels: int,
                 threads: int) -> int:
    """A block's shared memory, as the .cu's ``Layout<DS>`` lays it out
    (float32 throughout): the forward's two chunks of (dt, u, B, C) rows;
    the backward's two chunks of (dt, u, dy, B, C) rows, each thread's 16
    steps of four decays, and the warps' sums of dB and dC a step."""
    if direction == "forward":
        return 4 * 2 * CHUNK * (2 * channels + 2 * ds)
    return 4 * (2 * CHUNK * (3 * channels + 2 * ds)
                + CHUNK * threads * LANE_STATES
                + CHUNK * (threads // 32) * 2 * ds)


def plan(b: int, s: int, di: int, ds: int, dtype: torch.dtype,
         direction: str) -> Plan:
    """The launch's shape for ``u [b, s, di]`` of ``dtype`` with ``ds``
    states: ``ds / LANE_STATES`` lanes a (row, channel); the forward
    ``FWD_THREADS`` threads a block, the backward ``BWD_CHANNELS`` channels
    a block. Raises (ValueError, TypeError) for what the kernel does not
    take: ``ds`` ∉ STATE_DIMS, a dtype other than float32 / bfloat16, an
    unknown direction, a negative size, or more than SHARED_LIMIT shared
    bytes."""
    if ds not in STATE_DIMS:
        raise ValueError(f"d_state must be one of {STATE_DIMS}, got {ds}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"u must be float32 or bfloat16, got {dtype}")
    if direction not in _DIRECTION_CODE:
        raise ValueError(f"direction must be one of {DESIGNS}, got "
                         f"{direction!r}")
    if min(b, s, di) < 0:
        raise ValueError(f"sizes must not be negative: B {b}, S {s}, di {di}")
    lanes = ds // LANE_STATES
    if direction == "forward":
        threads = FWD_THREADS
        channels = threads // lanes
    else:
        channels = BWD_CHANNELS
        threads = channels * lanes
    blocks = -(-di // channels)
    smem = shared_bytes(direction, ds, channels, threads)
    if smem > SHARED_LIMIT:
        raise ValueError(f"{direction} at d_state {ds}: {smem} shared bytes, "
                         f"more than {SHARED_LIMIT}")
    return Plan(lanes, channels, threads, (blocks, b), smem,
                blocks if direction == "backward" else 0)


def hold_layout(p: Plan, direction: str, layout: tuple) -> None:
    """Raises RuntimeError unless the kernel's ``layout`` (lanes, channels,
    threads, shared bytes, from ``repro_selective_scan_layout``) is the
    plan's."""
    want = (p.lanes, p.channels, p.threads, p.shared_bytes)
    if tuple(layout) != want:
        raise RuntimeError(
            f"selective_scan {direction}: the kernel's layout (lanes, "
            f"channels, threads, shared bytes) {tuple(layout)} differs from "
            f"the plan's {want}")


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _library(name: str):
    fn = _bound.get(name)
    if fn is not None:
        return fn
    lib = build.load("selective_scan")
    if name == "layout":
        fn = lib.repro_selective_scan_layout
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int,          # direction, ds
                       ctypes.POINTER(ctypes.c_int),        # lanes, C, T
                       ctypes.POINTER(ctypes.c_longlong)]   # shared bytes
        _bound[name] = fn
        return fn
    if name == "forward":
        fn = lib.repro_selective_scan_fwd
        pointers = 9      # u, dt, A, B, C, h0, y, h_last, ck
    else:
        fn = lib.repro_selective_scan_bwd
        pointers = 13     # u, dt, A, B, C, ck, dy, dh_last, du, ddt,
        #                   dA_part, dbc_part, dh0
    fn.restype = ctypes.c_int
    fn.argtypes = [*[ctypes.c_void_p] * pointers,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, di
                   ctypes.c_int, ctypes.c_int,                # ds, u dtype
                   ctypes.c_int, ctypes.c_int,                # channels, T
                   ctypes.c_longlong,                         # shared bytes
                   ctypes.c_void_p]                           # stream
    _bound[name] = fn
    return fn


def _launch_plan(direction: str, u: torch.Tensor, ds: int) -> Plan:
    """The plan for ``u``, held against the kernel's layout (read once a
    direction and ``ds``); raises where they differ."""
    b, s, di = u.shape
    p = plan(b, s, di, ds, u.dtype, direction)
    key = (direction, ds)
    if key not in _layouts:
        out, smem = (ctypes.c_int * 3)(), ctypes.c_longlong(0)
        err = _library("layout")(_DIRECTION_CODE[direction], ds, out,
                                 ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"selective_scan {direction}: the layout "
                               f"query failed, cudaError {err} (ds={ds})")
        _layouts[key] = (*out, smem.value)
    hold_layout(p, direction, _layouts[key])
    return p


def _check(u, dt, a, bm, cm, h0) -> None:
    if u.dim() != 3:
        raise ValueError(f"u must be [B, S, di], got {tuple(u.shape)}")
    b, s, di = u.shape
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"a must be [{di}, ds], got {tuple(a.shape)}")
    ds = a.shape[1]
    shapes = {"dt": (dt, (b, s, di)), "bm": (bm, (b, s, ds)),
              "cm": (cm, (b, s, ds))}
    if h0 is not None:
        shapes["h0"] = (h0, (b, di, ds))
    for name, (t, want) in {"a": (a, (di, ds)), **shapes}.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u is on {u.device}")


def selective_scan_fwd(u, dt, a, bm, cm, h0=None, save: bool = False):
    """One forward launch → (``y [B, S, di]``, the last ``h [B, di, ds]``,
    the checkpoints ``[B, checkpoints(S), di, ds]`` when ``save`` else
    None), float32. CUDA tensors only (fake ones included)."""
    _check(u, dt, a, bm, cm, h0)
    b, s, di = u.shape
    ds = a.shape[1]
    plan(b, s, di, ds, u.dtype, "forward")
    if u.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, u is on {u.device}")
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((b, s, di), **f32)
    h_last = torch.empty((b, di, ds), **f32)
    ck = torch.empty((b, checkpoints(s), di, ds), **f32) if save else None
    if compat.is_fake(u):
        _fake["calls"]["forward"] += 1
        _fake["flops"] += work(u, ds, "forward", save)["flops"]
        return y, h_last, ck
    if h0 is None:
        h0 = torch.zeros((b, di, ds), **f32)
    u, dt, a, bm, cm, h0 = (t.contiguous() for t in (u, dt, a, bm, cm, h0))
    if s == 0:
        return y, h_last.copy_(h0), ck
    p = _launch_plan("forward", u, ds)
    fn = _library("forward")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(u.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                 cm.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                 None if ck is None else ck.data_ptr(), b, s, di, ds,
                 _DTYPE_CODE[u.dtype], p.channels, p.threads,
                 p.shared_bytes, stream)
    _launches["forward"] += 1
    if err != 0:
        raise RuntimeError(
            f"selective_scan forward launch failed: cudaError {err} "
            f"(u={tuple(u.shape)} {u.dtype}, ds={ds}, {p})")
    return y, h_last, ck


def selective_scan_bwd(u, dt, a, bm, cm, h0, ck, dy, dh_last=None):
    """The gradient of ``selective_scan``'s (y, last h) given ``dy [B, S,
    di]`` and ``dh_last [B, di, ds]`` (zeros when None) → (du, ddt, da,
    dbm, dcm, dh0), float32: one backward launch from the forward's
    checkpoints ``ck``, then the sums of its partials. CUDA tensors only
    (fake ones included)."""
    _check(u, dt, a, bm, cm, h0)
    b, s, di = u.shape
    ds = a.shape[1]
    partials = plan(b, s, di, ds, u.dtype, "backward").partials
    if u.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, u is on {u.device}")
    if ck is None or tuple(ck.shape) != (b, checkpoints(s), di, ds):
        raise ValueError("the backward kernel needs the forward's checkpoints"
                         f" [{b}, {checkpoints(s)}, {di}, {ds}]")
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty((b, s, di), **f32)
    ddt = torch.empty((b, s, di), **f32)
    da_part = torch.empty((b, di, ds), **f32)
    dbc_part = torch.empty((partials, b, s, 2 * ds), **f32)
    dh0 = torch.empty((b, di, ds), **f32)
    if compat.is_fake(u):
        _fake["calls"]["backward"] += 1
        _fake["flops"] += work(u, ds, "backward")["flops"]
    elif s == 0:
        dbc_part.zero_()
        da_part.zero_()
        dh0.copy_(torch.zeros_like(dh0) if dh_last is None else dh_last)
    else:
        u, dt, a, bm, cm, ck, dy = (
            t.contiguous() for t in (u, dt, a, bm, cm, ck, dy))
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        p = _launch_plan("backward", u, ds)
        fn = _library("backward")
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(u.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                     cm.data_ptr(), ck.data_ptr(), dy.data_ptr(),
                     None if dh_last is None else dh_last.data_ptr(),
                     du.data_ptr(), ddt.data_ptr(), da_part.data_ptr(),
                     dbc_part.data_ptr(), dh0.data_ptr(), b, s, di, ds,
                     _DTYPE_CODE[u.dtype], p.channels, p.threads,
                     p.shared_bytes, stream)
        _launches["backward"] += 1
        if err != 0:
            raise RuntimeError(
                f"selective_scan backward launch failed: cudaError {err} "
                f"(u={tuple(u.shape)} {u.dtype}, ds={ds}, {p})")
    dbm, dcm = dbc_part.sum(dim=0).split(ds, dim=-1)
    return du, ddt, da_part.sum(dim=0), dbm, dcm, dh0


class Scan(torch.autograd.Function):
    """``selective_scan`` with a gradient on CUDA tensors: the forward
    launch saving its checkpoints, the backward launch."""

    @staticmethod
    def forward(ctx, u, dt, a, bm, cm, h0):
        y, h_last, ck = selective_scan_fwd(u, dt, a, bm, cm, h0, True)
        ctx.save_for_backward(u, dt, a, bm, cm, h0, ck)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, dt, a, bm, cm, h0, ck = ctx.saved_tensors
        du, ddt, da, dbm, dcm, dh0 = selective_scan_bwd(
            u, dt, a, bm, cm, h0, ck, dy, dh_last)
        return du.to(u.dtype), ddt, da, dbm, dcm, dh0


def selective_scan(u, dt, a, bm, cm, h0=None, *, chunk: int = 256):
    """(``y [B, S, di]``, the last ``h [B, di, ds]``), float32 (module
    docstring). ``chunk`` is the plain version's steps a chunk (CPU
    tensors); the kernel has no such choice."""
    if u.device.type == "cpu":
        _check(u, dt, a, bm, cm, h0)
        return ref.selective_scan_ref(u, dt, a, bm, cm, h0, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (u, dt, a, bm, cm, h0)):
        if h0 is None:
            h0 = torch.zeros((u.shape[0], u.shape[2], a.shape[1]),
                             dtype=torch.float32, device=u.device)
        return Scan.apply(u, dt, a, bm, cm, h0)
    return selective_scan_fwd(u, dt, a, bm, cm, h0)[:2]
