"""Decode attention (one query per head against a KV cache) on Hopper.

Counterpart of the JAX package's ``kernels/decode_attention.py``. Same
signature as the TPU kernel's entry point minus its block size: any cache
length S is accepted. Two designs, fixed by the dtype in ``design()``:

* ``"mma"`` — bfloat16 at every head_dim (``csrc/decode_attention_mma.cu``):
  the G query heads of a KV head are the 16 rows of ``mma.sync`` m16n8k16
  tiles for Q·Kᵀ and P·V; each warp streams its own 32-slot tiles through
  a ring of ``cp.async`` stages;
* ``"ffma"`` — float32 at every head_dim (``csrc/decode_attention.cu``):
  full-precision FFMA (no TF32). A block of eight warps streams 32-slot
  tiles (64 at head_dim 16) through a ring of ``cp.async`` stages (96 KB a
  block at two blocks an SM, 192 KB at one); each warp owns an eighth of
  every tile's slots and its own (m, l, O) for all G heads, so every warp
  works at any group, and the warps merge once at the end of the block.
  The kernel is compiled for the group rounded up to 2, 4, 8 or 16 heads.

Both split the cache into a balanced partition of its tiles (``split_plan``)
so that the blocks fill whole waves (to ``WAVE_FILL``) of what the design
keeps resident per SM, read once per (device, design, head_dim, group)
from the CUDA occupancy calculator. Both combine the splits inside the
same launch: each block writes its partial (m, l, acc), and the last block
of its (batch, KV head) to arrive combines them, counted on int32 arrival
counters (``_split_counters``) that it sets back to 0, so a launch replays
from a CUDA graph.

``q [B, H, 1, D]`` and ``k``/``v [B, KV, S, D]`` may have any element
strides with unit stride on D, so the model passes its ``[B, S, KV, D]``
caches as ``cache.transpose(1, 2)`` views. ``length`` — the number of
valid cache slots — is a Python int or an int32 tensor ``[]`` or ``[B]``
on q's device; the kernel reads it there, so a decode step never waits on
the host. Slots from ``length`` on are not read; ``length = 0`` gives
zeros (the Pallas kernel's result; the JAX oracle averages V instead).
The output is ``[B, H, 1, D]``, laid out as ``[B, 1, H, D]``.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``; a
CUDA tensor launches the design's kernel or raises (also when the build
fails). Every call on the card adds one to ``launch_count()`` and to its
design's entry of ``launch_count_by_design()``. A fake CUDA tensor
(``compat.is_fake``, the dry run) gets the kernel's output layout and
launches nothing, since it holds no data: the call adds one to
``fake_calls_by_design()`` under the design a real call would launch, and
its FLOPs (``work``) to ``fake_flops()``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    MAX_GRID_Y,
    check_heads,
    kernel_strides,
)

DESIGNS = ("mma", "ffma")
# design -> (csrc/<source>.cu, its C entry point; "<entry>_occupancy" too)
LIBRARIES = {
    "mma": ("decode_attention_mma", "repro_decode_attention_mma"),
    "ffma": ("decode_attention", "repro_decode_attention"),
}
MAX_GROUP = 16     # query heads per KV head that one block holds
MAX_SPLITS = 256   # each design's combine holds [16, splits] weights
# Cache slots of an ffma tile: the constexpr lines kTile and kTileD16 of
# csrc/decode_attention.cu.
FFMA_TILE, FFMA_TILE_D16 = 32, 64
WAVE_FILL = 0.95   # split_plan: the least share of its last wave a plan fills

_launches = dict.fromkeys(DESIGNS, 0)
# Calls on fake tensors (the dry run), by the design a real call would
# launch, and the FLOPs they stand for; none of them launched anything.
_fake = {"calls": dict.fromkeys(DESIGNS, 0), "flops": 0}
_bound: dict[str, tuple] = {}
_sm_counts: dict[int, int] = {}
_resident: dict[tuple, int] = {}
_counters: dict[int, torch.Tensor] = {}


def launch_count() -> int:
    """Kernel launches made by this module's wrapper so far (all designs)."""
    return sum(_launches.values())


def launch_count_by_design() -> dict[str, int]:
    """Launches so far of each design (the keys of ``DESIGNS``)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def fake_calls_by_design() -> dict[str, int]:
    """Calls on fake tensors so far (``compat.is_fake``), none of which
    launched, by the design a real call would have launched."""
    return dict(_fake["calls"])


def fake_flops() -> int:
    """The FLOPs (``work``) that those calls stand for."""
    return _fake["flops"]


def reset_fake_calls() -> None:
    for name in _fake["calls"]:
        _fake["calls"][name] = 0
    _fake["flops"] = 0


def _fake_call(name: str, flops: int) -> None:
    _fake["calls"][name] += 1
    _fake["flops"] += flops


def work(q: torch.Tensor, k: torch.Tensor, length: int) -> dict:
    """``{"flops", "bytes"}`` of one launch on ``q [B,H,1,D]`` against
    ``k``/``v [B,KV,S,D]`` up to ``length`` slots: 4·D FLOPs a (head,
    slot) pair (Q·Kᵀ and P·V), and K and V up to ``length`` plus q and o
    moved once."""
    b, kv, _, d = k.shape
    return {"flops": 4 * d * q.shape[1] * b * length,
            "bytes": (2 * b * kv * length * d + 2 * q.numel())
            * q.element_size()}


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel design that serves ``(dtype, head_dim)``: a fixed table,
    no caller can choose another."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one of {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "ffma"
    raise TypeError(f"no decode_attention design for {dtype}")


def tile_slots(dtype: torch.dtype, head_dim: int) -> int:
    """Cache slots of one tile of the design serving ``(dtype, head_dim)``,
    the unit of a split: for ``mma`` a warp's step, 32 slots (16 at
    head_dim 256); for ``ffma`` a block's, whose eight warps take an eighth
    each, 32 slots (64 at head_dim 16, where a warp's slots must be 8 for
    its lanes to split the 4 chunks of a row). Each library reports its
    own, and the wrapper raises on a mismatch."""
    if design(dtype, head_dim) == "mma":
        return 16 if head_dim == 256 else 32
    return FFMA_TILE_D16 if head_dim == 16 else FFMA_TILE


def split_plan(batch: int, kv_heads: int, s: int, sm_count: int,
               blocks_per_sm: int, tile: int) -> tuple[int, int]:
    """``(tiles, splits)``: the cache's ``ceil(s / tile)`` tiles and the
    number of balanced parts they are cut into (split ``i`` takes tiles
    ``[i·tiles//splits, (i+1)·tiles//splits)``), one block each per
    (batch, KV head).

    A wave is ``sm_count·blocks_per_sm`` resident blocks. The plan takes
    the fewest splits whose ``batch·kv_heads·splits`` blocks fill their
    last wave to ``WAVE_FILL`` or more, within ``min(tiles, MAX_SPLITS)``;
    where none does, the count whose last wave is fullest (the fewest
    among equals). Fewer splits mean longer blocks, so less of each
    block's fixed cost (its first loads, the merge of its warps, the
    combine of the splits) per byte."""
    tiles = max(1, math.ceil(s / tile))
    groups = batch * kv_heads
    wave = sm_count * blocks_per_sm

    def fill(n: int) -> float:
        blocks = groups * n
        return blocks / (math.ceil(blocks / wave) * wave)

    counts = range(1, min(tiles, MAX_SPLITS) + 1)
    for n in counts:
        if fill(n) >= WAVE_FILL:
            return tiles, n
    return tiles, max(counts, key=lambda n: (fill(n), -n))


def _library(name: str):
    """(launcher, occupancy query) of a design's source."""
    fns = _bound.get(name)
    if fns is not None:
        return fns
    source, symbol = LIBRARIES[name]
    lib = build.load(source)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p,                                    # o
        ctypes.c_void_p, ctypes.c_longlong,                 # length, stride
        ctypes.POINTER(ctypes.c_longlong),                  # 11 strides
        *[ctypes.c_void_p] * 4,                             # m, l, acc, counters
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, H, KV
        ctypes.c_int, ctypes.c_int,                         # S, D
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # tile, tiles, splits
        ctypes.c_float,                                     # softcap
        ctypes.c_void_p,                                    # stream
    ]
    occ = getattr(lib, f"{symbol}_occupancy")
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _bound[name] = (fn, occ)
    return fn, occ


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _sm_count(device: torch.device) -> int:
    index = _device_index(device)
    if index not in _sm_counts:
        props = torch.cuda.get_device_properties(index)
        _sm_counts[index] = props.multi_processor_count
    return _sm_counts[index]


def resident_blocks(dtype: torch.dtype, head_dim: int, group: int,
                    device: torch.device) -> int:
    """Blocks per SM that the design serving ``(dtype, head_dim)`` keeps
    resident on ``device`` (the CUDA occupancy calculator, read once)."""
    name = design(dtype, head_dim)
    key = (_device_index(device), name, head_dim, group)
    if key not in _resident:
        _, occ = _library(name)
        blocks, tile = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = occ(head_dim, group, ctypes.byref(blocks), ctypes.byref(tile))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(
                f"decode_attention ({name}) occupancy query failed: error "
                f"{err}, {blocks.value} blocks per SM (head_dim {head_dim})")
        if tile.value != tile_slots(dtype, head_dim):
            raise RuntimeError(
                f"decode_attention ({name}) kernel tile {tile.value} != "
                f"tile_slots() {tile_slots(dtype, head_dim)}")
        _resident[key] = blocks.value
    return _resident[key]


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """int32 zeros, at least ``n``, kept per device: the kernels' arrival
    counters, which each launch leaves at 0."""
    index = _device_index(device)
    buf = _counters.get(index)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 0)
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _counters[index] = buf
    return buf


def _check_length(length, b: int, device: torch.device):
    if isinstance(length, torch.Tensor):
        if length.dtype != torch.int32:
            raise TypeError(f"length must be int32, got {length.dtype}")
        if length.device != device:
            raise ValueError(f"length is on {length.device}, q is on {device}")
        if length.dim() > 1 or (length.dim() == 1 and length.shape[0] != b):
            raise ValueError(
                f"length must be [] or [{b}], got {tuple(length.shape)}"
            )
    elif not isinstance(length, int) or isinstance(length, bool):
        raise TypeError(
            f"length must be an int or an int32 tensor, got {type(length)}"
        )


def decode_attention(
    q: torch.Tensor,       # [B, H, 1, D]
    k: torch.Tensor,       # [B, KV, S, D]
    v: torch.Tensor,       # [B, KV, S, D]
    length,                # int, or int32 tensor [] or [B]
    *,
    softcap: float | None = None,
) -> torch.Tensor:
    check_heads(q, k, v)
    b, h, one, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    if one != 1:
        raise ValueError(f"q must be [B, H, 1, D], got {tuple(q.shape)}")
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads per KV head > {MAX_GROUP}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    _check_length(length, b, q.device)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, length, softcap=softcap)
    if b * kv > MAX_GRID_Y:
        raise ValueError(f"B*KV = {b * kv} exceeds the grid limit {MAX_GRID_Y}")
    # A fake call's FLOPs at the cache's depth where length is a tensor
    # (it holds no value to read).
    depth = s if isinstance(length, torch.Tensor) else length
    if not isinstance(length, torch.Tensor):
        length = torch.full((), length, dtype=torch.int32, device=q.device)
    len_stride = length.stride(0) if length.dim() == 1 and b > 1 else 0
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    out = out.transpose(1, 2)
    if out.numel() == 0:
        return out
    name = design(q.dtype, d)
    if compat.is_fake(q):
        _fake_call(name, work(q, k, depth)["flops"])
        return out
    tile = tile_slots(q.dtype, d)
    tiles, splits = split_plan(
        b, kv, s, _sm_count(q.device),
        resident_blocks(q.dtype, d, h // kv, q.device), tile)
    # One scratch tensor: acc [B*H*splits*D] first (16-byte aligned), then
    # m and l [B*H*splits]; and the arrival counters. None at one split.
    rows = b * h * splits
    parts = [0, 0, 0, 0]
    if splits > 1:
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=q.device)
        acc_ptr = scratch.data_ptr()
        parts = [acc_ptr + 4 * rows * d, acc_ptr + 4 * rows * (d + 1), acc_ptr,
                 _split_counters(q.device, b * kv).data_ptr()]
    strides = kernel_strides(q, k, v) + kernel_strides(out, dims=2)
    fn, _ = _library(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            length.data_ptr(), len_stride,
            (ctypes.c_longlong * 11)(*strides), *parts,
            b, h, kv, s, d, tile, tiles, splits, float(softcap or 0.0),
            stream,
        )
    _launches[name] += 1
    if err != 0:
        raise RuntimeError(
            f"decode_attention ({name}) kernel launch failed: cudaError {err} "
            f"(q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype})"
        )
    return out
