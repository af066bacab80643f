"""Decode attention (one query per head against a KV cache) on Hopper.

Counterpart of the JAX package's ``kernels/decode_attention.py`` over one
CUDA source (``csrc/decode_attention.cu``): a split-along-the-cache
kernel in which the query heads of one KV head share every K/V tile, and a
small kernel that combines the splits. Same signature as the TPU kernel's
entry point minus its block size: any cache length S is accepted.

``q [B, H, 1, D]`` and ``k``/``v [B, KV, S, D]`` may have any element
strides with unit stride on D, so the model passes its ``[B, S, KV, D]``
caches as ``cache.transpose(1, 2)`` views. ``length`` — the number of
valid cache slots — is a Python int or an int32 tensor ``[]`` or ``[B]``
on q's device; the kernel reads it there, so a decode step never waits on
the host. Slots from ``length`` on are not read; ``length = 0`` gives
zeros (the Pallas kernel's result; the JAX oracle averages V instead).
The output is ``[B, H, 1, D]``, laid out as ``[B, 1, H, D]``.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``; a
CUDA tensor launches the kernels or raises. Every call on the card adds
one to ``launch_count()`` (the split and the combine are one launch of
this wrapper).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (
    DTYPE_CODE,
    MAX_GRID_Y,
    check_heads,
    kernel_strides,
)

# Cache slots per split unit: a split is a multiple of TILE. The kernel's
# tile is 64 slots, or 32 for float32 at head_dim 256 (so that its two
# stages fit in shared memory); both divide TILE, so every split is whole
# tiles either way.
TILE = 64
MAX_GROUP = 16     # query heads per KV head that one block holds
BLOCKS_PER_SM = 4  # split target: this many blocks per SM

_launches = 0
_bound = None
_sm_counts: dict[int, int] = {}


def launch_count() -> int:
    """Kernel launches made by this module's wrapper so far."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library():
    global _bound
    if _bound is None:
        fn = build.load("decode_attention").repro_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,                                    # o
            ctypes.c_void_p, ctypes.c_longlong,                 # length, stride
            ctypes.POINTER(ctypes.c_longlong),                  # 11 strides
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # partials
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, H, KV
            ctypes.c_int, ctypes.c_int,                         # S, D
            ctypes.c_int, ctypes.c_int,                         # chunk, splits
            ctypes.c_float,                                     # softcap
            ctypes.c_int,                                       # dtype code
            ctypes.c_void_p,                                    # stream
        ]
        _bound = fn
    return _bound


def split_plan(batch: int, kv_heads: int, s: int, sm_count: int):
    """``(chunk, splits)``: cache slots per split (a multiple of ``TILE``)
    and their number, so that ``batch·kv_heads·splits`` blocks give about
    ``BLOCKS_PER_SM`` blocks to each SM, never more splits than tiles."""
    tiles = max(1, math.ceil(s / TILE))
    want = math.ceil(BLOCKS_PER_SM * sm_count / max(1, batch * kv_heads))
    splits = max(1, min(want, tiles))
    chunk = math.ceil(tiles / splits) * TILE
    return chunk, math.ceil(max(s, 1) / chunk)


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        props = torch.cuda.get_device_properties(index)
        _sm_counts[index] = props.multi_processor_count
    return _sm_counts[index]


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
    global _launches
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
    if not isinstance(length, torch.Tensor):
        length = torch.full((), length, dtype=torch.int32, device=q.device)
    len_stride = length.stride(0) if length.dim() == 1 and b > 1 else 0
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    out = out.transpose(1, 2)
    if out.numel() == 0:
        return out
    chunk, splits = split_plan(b, kv, s, _sm_count(q.device))
    part_m = torch.empty(b * h * splits, dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(
        b * h * splits * d, dtype=torch.float32, device=q.device
    )
    strides = kernel_strides(q, k, v) + kernel_strides(out, dims=2)
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            length.data_ptr(), len_stride,
            (ctypes.c_longlong * 11)(*strides),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            b, h, kv, s, d, chunk, splits, float(softcap or 0.0),
            DTYPE_CODE[q.dtype], stream,
        )
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: cudaError {err} "
            f"(q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype})"
        )
    return out
