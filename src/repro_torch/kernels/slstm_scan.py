"""sLSTM's recurrence (xLSTM's scalar-memory block), forward and backward,
on Hopper.

Replaces no TPU kernel: the JAX package steps the cell with XLA's
``jax.lax.scan``. Each step adds the rounded recurrent product
``round(round(h_{t-1}) @ R)`` to the step's input projections and applies
the cell's exponential gating (``ref.slstm_step_ref``); the whole loop
over S runs in one launch a layer. ``pre_x [B, S, 4·d]`` and the carry
``{c, n, h, m}`` ``[B, d]`` are float32; ``r [d, 4·d]`` is in the compute
dtype (float32 or bfloat16), whose rounding is part of the function.

The design (``csrc/slstm_scan.cu``) is a persistent cooperative grid:
``plan`` splits the ``d`` hidden units (``d`` even, ``≤ MAX_D``) into
``P = ⌈d / U⌉`` groups of ``U ≤ MAX_UNITS`` units, one block each, with
``P`` no more than the blocks the card holds at once (one an SM). A block
keeps its part of R in shared memory for the whole launch — the forward
R's ``4·U`` columns of its units, the backward R's ``U`` rows — and loops
over the batch in tiles of ``rows``. The blocks pass ``round(h)``
(forward) or ``round(dpre)`` (backward) through a double-buffered exchange
buffer in global memory and meet at one grid barrier a step. The launch
is ``cudaLaunchCooperativeKernel``: the card holds all ``P`` blocks at once
or refuses it. Before launching, the wrapper checks the plan's shared
bytes against the kernel's and ``P`` against the occupancy calculator's
blocks an SM × the SMs, and raises where they do not fit; there is no
other design to fall back to. The wrapper allocates the exchange buffers
and the barrier's counter (zeroed) for each launch. Three entry points:

* ``slstm_scan(pre_x, r, carry)`` → (``hs [B, S, d]``, the last carry):
  what ``models/ssm.slstm_prefill`` calls. When a gradient is wanted on a
  CUDA tensor it goes through ``Scan``, a ``torch.autograd.Function``
  whose forward saves each step's pre-activations and (c, n, m) and whose
  backward is the backward kernel, then ``dR = H_prevᵀ·dpre`` as one
  matrix product;
* ``slstm_scan_fwd(...)`` → (hs, the last carry, the saved tensors or
  None): one forward launch;
* ``slstm_scan_bwd(...)`` → (dpre, the initial carry's gradient): one
  backward launch.

On the CPU ``slstm_scan`` is the plain version in ``kernels/ref.py``
(``slstm_scan_ref``, differentiated by autograd; ``slstm_scan_bwd_ref`` is
the backward kernel's plain version); a CUDA tensor launches the kernel or
raises (also when the build fails or the grid cannot be co-resident).
Every launch adds one to ``launch_count()`` and to its direction's entry
of ``launch_count_by_design()``. A fake CUDA tensor (``compat.is_fake``,
the dry run) gets what the launch allocates, the saved tensors included,
and launches nothing: the call adds one to ``fake_calls_by_design()`` and
its FLOPs (``work``) to ``fake_flops()``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

DESIGNS = ("forward", "backward")
MAX_D = 1024          # the .cu's kMaxD
MAX_UNITS = 8         # units a block: 4·U ≤ 32 columns, a warp's lanes
ROW_TILE = 16         # rows of a tile at most: mma's M
WARPS = 8             # a block's warps (256 threads)
SHARED_LIMIT = 232_448  # shared bytes a block can have on Hopper (227 KB)
COUNTER_BYTES = 16    # the barrier's counter at the scratch's start
CARRY = ("c", "n", "h", "m")
# FLOPs of a (token, element) beside the recurrent product's 2 a (k,
# column): the forward's cell (the rounding's add, tanh, sigmoid,
# log-sigmoid, the stabilizer and the update, 20 counting each
# transcendental as one), the backward's reverse cell (40).
FWD_CELL_FLOPS, BWD_CELL_FLOPS = 20, 40
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DIRECTION_CODE = {"forward": 0, "backward": 1}

_launches = dict.fromkeys(DESIGNS, 0)
_fake = {"calls": dict.fromkeys(DESIGNS, 0), "flops": 0}
_bound: dict[str, object] = {}
_resident: dict[tuple, tuple[int, int]] = {}


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


def work(pre_x: torch.Tensor, r: torch.Tensor, direction: str = "forward",
         saved: bool = False) -> dict:
    """``{"flops", "product_flops", "bytes"}`` of one launch on ``pre_x
    [B, S, 4·d]``: the recurrent product's 2·d·4d FLOPs a token (in r's
    dtype; ``product_flops``) and the cell's (float32); each input
    read once and each output written once — forward: pre_x, r and the
    carry in, hs and the carry out (and, when ``saved``, the
    pre-activations and (c, n, m) of every step); backward: the saved
    tensors, r, the carry, hs's and the last carry's gradients in, dpre
    and the carry's gradient out."""
    b, s, d4 = pre_x.shape
    d = d4 // 4
    tokens = b * s
    carry = 2 * 4 * b * d * 4
    r_bytes = r.numel() * r.element_size()
    product = tokens * 2 * d * d4
    if direction == "forward":
        moved = tokens * (d4 + d) * 4 + r_bytes + carry
        if saved:
            moved += tokens * (d4 + 3 * d) * 4
        return {"flops": product + tokens * FWD_CELL_FLOPS * d,
                "product_flops": product, "bytes": moved}
    moved = tokens * (d4 + 3 * d + d + d4) * 4 + r_bytes + carry
    return {"flops": product + tokens * BWD_CELL_FLOPS * d,
            "product_flops": product, "bytes": moved}


# ---------------------------------------------------------------------------
# The plan: units a block, blocks, rows a tile, shared bytes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's partition: ``blocks`` groups of ``units`` consecutive
    hidden units (the last may be partial), ``rows`` rows of the batch a
    tile, ``shared_bytes`` of shared memory a block, and the elements of
    a row of the exchange buffer (``exchange_stride``)."""
    units: int
    blocks: int
    rows: int
    shared_bytes: int
    exchange_stride: int


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def shared_bytes(direction: str, r_dtype: torch.dtype, d: int, units: int,
                 rows: int) -> int:
    """A block's shared memory, as the .cu's ``fwd_layout`` /
    ``bwd_layout`` lay it out: R's part in its dtype, the staged tile of
    the exchange buffer, the warps' partial sums ``[WARPS, rows, cols]``
    (float32; double in the bf16 backward). bf16 rows of R and of the tile
    are padded to a multiple of 16 elements plus 8 (the banks), R's
    columns (forward) to n-tiles of 8 and its rows (backward) to 8, and
    the tile has ROW_TILE rows."""
    if direction == "forward":
        if r_dtype == torch.bfloat16:
            stride, cols = _round_up(d, 16) + 8, _round_up(4 * units, 8)
            head = 2 * cols * stride + 2 * ROW_TILE * stride
        else:
            cols = 4 * units
            head = 4 * d * cols + 4 * rows * _round_up(d, 8)
    else:
        cols = MAX_UNITS
        if r_dtype == torch.bfloat16:
            stride = _round_up(4 * d, 16) + 8
            head = 2 * MAX_UNITS * stride + 2 * ROW_TILE * stride
            return head + 8 * WARPS * rows * cols
        head = 4 * units * (4 * d + 4) + 4 * rows * 4 * d
    return head + 4 * WARPS * rows * cols


def plan(d: int, r_dtype: torch.dtype, direction: str, limit: int) -> Plan:
    """The partition of a layer of width ``d`` over at most ``limit``
    co-resident blocks: the fewest units a block that keep ``⌈d / U⌉ ≤
    limit``; bf16 tiles of ROW_TILE rows (the forward's mma M), float32
    tiles of as many rows (at most ROW_TILE) as shared memory holds.
    Raises ValueError for an odd ``d``, ``d > MAX_D``, or a plan that needs
    more than MAX_UNITS units a block or SHARED_LIMIT bytes."""
    if d < 2 or d % 2 or d > MAX_D:
        raise ValueError(f"the kernel takes an even d ≤ {MAX_D}, got {d}")
    if r_dtype not in _DTYPE_CODE:
        raise TypeError(f"r must be float32 or bfloat16, got {r_dtype}")
    if direction not in _DIRECTION_CODE:
        raise ValueError(f"direction must be one of {DESIGNS}, got "
                         f"{direction!r}")
    if limit < 1:
        raise ValueError(f"a plan needs at least one block, limit {limit}")
    units = -(-d // limit)
    blocks = -(-d // units)
    if units > MAX_UNITS:
        raise ValueError(
            f"d = {d} over at most {limit} co-resident blocks needs "
            f"{units} units a block (at most {MAX_UNITS}) and {blocks} "
            "blocks")
    if r_dtype == torch.bfloat16:
        rows = ROW_TILE
    else:
        fixed = shared_bytes(direction, r_dtype, d, units, 0)
        per_row = shared_bytes(direction, r_dtype, d, units, 1) - fixed
        rows = min(ROW_TILE, (SHARED_LIMIT - fixed) // per_row)
    smem = shared_bytes(direction, r_dtype, d, units, rows)
    if rows < 1 or smem > SHARED_LIMIT:
        raise ValueError(f"d = {d}, {units} units a block: {smem} shared "
                         f"bytes, more than {SHARED_LIMIT}")
    stride = _round_up(d, 8) if direction == "forward" else 4 * d
    return Plan(units, blocks, rows, smem, stride)


def sm_count(device: torch.device) -> int:
    """The SMs of ``device``: the plan's limit (one block an SM) and the
    occupancy check's multiplier."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def hold_resident(p: Plan, direction: str, smem: int, per_sm: int,
                  sms: int) -> None:
    """Raises RuntimeError unless the kernel's shared bytes ``smem`` are
    the plan's and its ``p.blocks`` fit at once in ``per_sm`` blocks an
    SM (the occupancy calculator's) × ``sms`` SMs: a cooperative launch
    needs the whole grid on the card at once."""
    if smem != p.shared_bytes:
        raise RuntimeError(f"slstm_scan {direction}: the plan's shared bytes "
                           f"{p.shared_bytes} differ from the kernel's {smem}")
    if p.blocks > per_sm * sms:
        raise RuntimeError(
            f"slstm_scan {direction}: {p.blocks} blocks cannot be "
            f"co-resident ({per_sm} an SM × {sms} SMs at {smem} shared "
            "bytes)")


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _library(name: str):
    fn = _bound.get(name)
    if fn is not None:
        return fn
    lib = build.load("slstm_scan")
    if name == "resident":
        fn = lib.repro_slstm_scan_resident
        fn.argtypes = [*[ctypes.c_int] * 5,  # direction, r dtype, d, U, rows
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int)]
    else:
        if name == "forward":
            fn = lib.repro_slstm_scan_fwd
            # pre_x, R, carry0, hs, carry, pre_save, st_save, scratch
            pointers = 8
        else:
            fn = lib.repro_slstm_scan_bwd
            # pre, st, R, carry0, dhs, dlast, dpre, dcarry0, scratch
            pointers = 9
        fn.argtypes = [*[ctypes.c_void_p] * pointers,
                       *[ctypes.c_int] * 6,  # B, S, d, U, rows, r dtype
                       ctypes.c_void_p]      # stream
    fn.restype = ctypes.c_int
    _bound[name] = fn
    return fn


def _launch_plan(direction: str, r: torch.Tensor, d: int) -> Plan:
    """The plan for ``r``'s card, held against the kernel: its shared
    bytes equal to the .cu's layout, and its blocks co-resident by the
    occupancy calculator (blocks an SM × the SMs); raises otherwise."""
    sms = sm_count(r.device)
    p = plan(d, r.dtype, direction, sms)
    key = (direction, r.dtype, d, p.units, p.rows, r.device.index)
    if key not in _resident:
        smem, per_sm = ctypes.c_longlong(0), ctypes.c_int(0)
        with torch.cuda.device(r.device):
            err = _library("resident")(
                _DIRECTION_CODE[direction], _DTYPE_CODE[r.dtype], d, p.units,
                p.rows, ctypes.byref(smem), ctypes.byref(per_sm))
        if err != 0:
            raise RuntimeError(f"slstm_scan {direction}: the occupancy query "
                               f"failed, cudaError {err} ({p})")
        _resident[key] = (smem.value, per_sm.value)
    hold_resident(p, direction, *_resident[key], sms)
    return p


def _scratch(p: Plan, batch: int, r: torch.Tensor) -> torch.Tensor:
    """The barrier's counter then two exchange buffers ``[batch,
    exchange_stride]`` in r's dtype, zeroed (the padding stays zero)."""
    size = COUNTER_BYTES + 2 * batch * p.exchange_stride * r.element_size()
    return torch.zeros(size, dtype=torch.uint8, device=r.device)


def _check(pre_x, r, carry: dict) -> None:
    if pre_x.dim() != 3 or pre_x.shape[-1] % 4:
        raise ValueError(f"pre_x must be [B, S, 4·d], got {tuple(pre_x.shape)}")
    b, _, d4 = pre_x.shape
    d = d4 // 4
    if pre_x.dtype != torch.float32:
        raise TypeError(f"pre_x must be float32, got {pre_x.dtype}")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    if tuple(r.shape) != (d, d4):
        raise ValueError(f"r must be [{d}, {d4}], got {tuple(r.shape)}")
    for name in CARRY:
        t = carry[name]
        if tuple(t.shape) != (b, d) or t.dtype != torch.float32:
            raise ValueError(f"carry[{name!r}] must be float32 [{b}, {d}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in {"r": r, **carry}.items():
        if t.device != pre_x.device:
            raise ValueError(
                f"{name} is on {t.device}, pre_x is on {pre_x.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on 16 bytes."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stacked(carry: dict) -> torch.Tensor:
    return torch.stack([carry[k].to(torch.float32) for k in CARRY])


def _unstacked(t: torch.Tensor) -> dict:
    return dict(zip(CARRY, t.unbind(0)))


def slstm_scan_fwd(pre_x, r, carry: dict, save: bool = False):
    """One forward launch → (``hs [B, S, d]``, the last carry, the saved
    ``(pre [B, S, 4·d], states [3, B, S, d])`` when ``save`` else None),
    float32. CUDA tensors only (fake ones included)."""
    _check(pre_x, r, carry)
    b, s, d4 = pre_x.shape
    d = d4 // 4
    if d > MAX_D or d % 2:
        raise ValueError(f"the kernel takes an even d ≤ {MAX_D}, got {d}")
    if pre_x.device.type != "cuda":
        raise ValueError(
            f"the kernel takes CUDA tensors, pre_x is on {pre_x.device}")
    f32 = dict(dtype=torch.float32, device=pre_x.device)
    hs = torch.empty((b, s, d), **f32)
    last = torch.empty((4, b, d), **f32)
    saved = ((torch.empty((b, s, d4), **f32),
              torch.empty((3, b, s, d), **f32)) if save else None)
    if compat.is_fake(pre_x):
        _fake["calls"]["forward"] += 1
        _fake["flops"] += work(pre_x, r, "forward", save)["flops"]
        return hs, _unstacked(last), saved
    carry0 = _stacked(carry).contiguous()
    if s == 0:
        return hs, _unstacked(last.copy_(carry0)), saved
    pre_x, r = _aligned(pre_x), _aligned(r)
    p = _launch_plan("forward", r, d)
    scratch = _scratch(p, b, r)
    fn = _library("forward")
    with torch.cuda.device(pre_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pre_x.data_ptr(), r.data_ptr(), carry0.data_ptr(),
                 hs.data_ptr(), last.data_ptr(),
                 None if saved is None else saved[0].data_ptr(),
                 None if saved is None else saved[1].data_ptr(),
                 scratch.data_ptr(), b, s, d, p.units, p.rows,
                 _DTYPE_CODE[r.dtype], stream)
    _launches["forward"] += 1
    if err != 0:
        raise RuntimeError(
            f"slstm_scan forward launch failed: cudaError {err} "
            f"(pre_x={tuple(pre_x.shape)}, r={r.dtype}, {p})")
    return hs, _unstacked(last), saved


def slstm_scan_bwd(r, carry0: dict, dhs, dlast=None, *, saved):
    """The gradient of ``slstm_scan``'s (hs, last carry) given ``dhs [B,
    S, d]`` and ``dlast`` (the last carry's, zeros when None) → (``dpre [B,
    S, 4·d]``, the initial carry's gradient), float32: one backward launch
    from the forward's ``saved`` tensors. CUDA tensors only (fake ones
    included)."""
    pre, states = saved
    _check(pre, r, carry0)
    if pre.device.type != "cuda":
        raise ValueError(
            f"the kernel takes CUDA tensors, pre is on {pre.device}")
    b, s, d4 = pre.shape
    d = d4 // 4
    f32 = dict(dtype=torch.float32, device=pre.device)
    dpre = torch.empty((b, s, d4), **f32)
    dcarry0 = torch.empty((4, b, d), **f32)
    if compat.is_fake(pre):
        _fake["calls"]["backward"] += 1
        _fake["flops"] += work(pre, r, "backward")["flops"]
        return dpre, _unstacked(dcarry0)
    if s == 0:
        zero = torch.zeros((4, b, d), **f32)
        return dpre, _unstacked(
            dcarry0.copy_(zero if dlast is None else _stacked(dlast)))
    pre, states = pre.contiguous(), states.contiguous()
    c0 = _stacked(carry0).contiguous()
    dl = None if dlast is None else _stacked(dlast).contiguous()
    r, dhs = _aligned(r), dhs.contiguous()
    p = _launch_plan("backward", r, d)
    scratch = _scratch(p, b, r)
    fn = _library("backward")
    with torch.cuda.device(pre.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pre.data_ptr(), states.data_ptr(), r.data_ptr(),
                 c0.data_ptr(), dhs.data_ptr(),
                 None if dl is None else dl.data_ptr(), dpre.data_ptr(),
                 dcarry0.data_ptr(), scratch.data_ptr(), b, s, d, p.units,
                 p.rows, _DTYPE_CODE[r.dtype], stream)
    _launches["backward"] += 1
    if err != 0:
        raise RuntimeError(
            f"slstm_scan backward launch failed: cudaError {err} "
            f"(pre={tuple(pre.shape)}, r={r.dtype}, {p})")
    return dpre, _unstacked(dcarry0)


class Scan(torch.autograd.Function):
    """``slstm_scan`` with a gradient on CUDA tensors: the forward launch
    saving each step's pre-activations and (c, n, m), the backward launch
    and ``dR``. The carry goes in and out as (c, n, h, m); the last ``h`` is
    ``hs[:, -1]``, outside."""

    @staticmethod
    def forward(ctx, pre_x, r, c, n, h, m):
        hs, last, saved = slstm_scan_fwd(pre_x, r,
                                         {"c": c, "n": n, "h": h, "m": m},
                                         True)
        ctx.save_for_backward(r, c, n, h, m, hs, *saved)
        return hs, last["c"], last["n"], last["m"]

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm):
        r, c, n, h, m, hs, *saved = ctx.saved_tensors
        carry0 = {"c": c, "n": n, "h": h, "m": m}
        dlast = {"c": dc, "n": dn, "h": torch.zeros_like(dc), "m": dm}
        dpre, dcarry = slstm_scan_bwd(r, carry0, dhs, dlast,
                                      saved=tuple(saved))
        b, s, d = hs.shape
        h_prev = torch.cat([h.unsqueeze(1), hs.narrow(1, 0, s - 1)],
                           dim=1).to(r.dtype)
        dr = torch.matmul(h_prev.reshape(-1, d).T,
                          dpre.to(r.dtype).reshape(-1, 4 * d))
        return (dpre, dr, dcarry["c"], dcarry["n"], dcarry["h"],
                dcarry["m"])


def slstm_scan(pre_x, r, carry: dict):
    """(``hs [B, S, d]``, the last carry ``{c, n, h, m}``), float32
    (module docstring)."""
    if pre_x.device.type == "cpu":
        _check(pre_x, r, carry)
        return ref.slstm_scan_ref(pre_x, r, carry)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre_x, r, *carry.values())):
        hs, c, n, m = Scan.apply(pre_x, r, *(carry[k] for k in CARRY))
        return hs, {"c": c, "n": n, "h": hs.select(1, -1), "m": m}
    return slstm_scan_fwd(pre_x, r, carry)[:2]
