"""Blocked online-softmax attention (prefill) on Hopper.

Counterpart of the JAX package's ``kernels/flash_attention.py``: causal,
sliding-window, logit softcap, GQA, forward only. Same signature as the
TPU kernel's entry point minus its block sizes: any ``Sq``/``Sk`` is
accepted. Two designs, fixed by (dtype, head_dim) in ``design()``:

* ``"wgmma"`` — bfloat16 at every head_dim
  (``csrc/flash_attention_wgmma.cu``): TMA copies into a ring of shared
  memory slots fed by a producer warpgroup, ``wgmma`` for Q·Kᵀ and P·V
  in two consumer warpgroups, 128-row query tiles; rows swizzled at their
  own width (32, 64 or 128 bytes), 128-key tiles (64 at head_dim 256)
  (``wgmma_tile``);
* ``"ffma"`` — float32 at every head_dim (``csrc/flash_attention_ffma.cu``):
  full-precision FFMA, no TF32; 64-row query tiles of 256 threads, each
  thread a 4 × 4 tile of S and 4 rows × D/16 columns of O in registers,
  64-key K/V tiles through a ring of ``cp.async`` slots (``ffma_tile``).

Operands are ``[B, H, S, D]`` tensors of any element strides with unit
stride on D (``D`` ∈ {16, 32, 64, 128, 256}), so the model passes its
``[B, S, H, D]`` activations as ``x.transpose(1, 2)`` views. The output
is ``[B, H, Sq, D]``, laid out in memory as ``[B, Sq, H, D]`` (a
transposed view of a contiguous tensor) so that the model reshapes it to
``[B, Sq, H·D]`` without a copy.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``; a
CUDA tensor launches the design's kernel or raises (also when the build
fails). Every launch adds one to ``launch_count()`` and to its design's
entry of ``launch_count_by_design()``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GRID_Y = 65535
DESIGNS = ("wgmma", "ffma")
# design -> (csrc/<source>.cu, its C entry point)
LIBRARIES = {
    "wgmma": ("flash_attention_wgmma", "repro_flash_attention_wgmma"),
    "ffma": ("flash_attention_ffma", "repro_flash_attention_ffma"),
}
# The wgmma design's tile table, as Cfg<D> of csrc/flash_attention_wgmma.cu
# has it: query rows a block, threads a block (a producer warpgroup and
# two consumers; the consumers alone at head_dim 256), keys a tile and
# ring stages by head_dim.
WGMMA_BM = 128
WGMMA_BN = {16: 128, 32: 128, 64: 128, 128: 128, 256: 64}
WGMMA_STAGES = {16: 4, 32: 4, 64: 3, 128: 2, 256: 2}
# Largest byte stride a tensor map takes (2^40).
MAX_TMA_STRIDE = 1 << 40
# The ffma design's tile table, as csrc/flash_attention_ffma.cu has it:
# query rows a block, keys a tile, threads a block, floats of pad on a
# Q/K/V row and on a P row, K/V ring slots (at head_dim 256 and elsewhere).
FFMA_BM, FFMA_BN, FFMA_THREADS = 64, 64, 256
FFMA_PAD_KV, FFMA_PAD_P = 4, 8
FFMA_SLOTS_D256, FFMA_SLOTS = 2, 4

_launches = dict.fromkeys(DESIGNS, 0)
_bound: dict[str, object] = {}


def launch_count() -> int:
    """Kernel launches made by this module's wrapper so far (all designs)."""
    return sum(_launches.values())


def launch_count_by_design() -> dict[str, int]:
    """Launches so far of each design (the keys of ``DESIGNS``)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel design that serves ``(dtype, head_dim)``: a fixed table,
    no caller can choose another."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one of {HEAD_DIMS}")
    if dtype == torch.float32:
        return "ffma"
    if dtype == torch.bfloat16:
        return "wgmma"
    raise TypeError(f"no flash_attention design for {dtype}")


@dataclasses.dataclass(frozen=True)
class FfmaTile:
    bm: int           # query rows of a block
    bn: int           # keys of a tile
    threads: int      # threads of a block
    slots: int        # K/V ring slots: K(t), V(t), K(t+1), ...
    smem_bytes: int   # dynamic shared memory of a block


def ffma_tile(head_dim: int) -> FfmaTile:
    """The ``ffma`` design's tile at ``head_dim``, mirroring
    ``FfmaTile<D>`` of ``csrc/flash_attention_ffma.cu``: Q, the K/V ring
    and P in shared memory, rows padded, plus a float per row for each of
    the block's two key halves."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one of {HEAD_DIMS}")
    slots = FFMA_SLOTS_D256 if head_dim == 256 else FFMA_SLOTS
    ld = head_dim + FFMA_PAD_KV
    floats = (FFMA_BM * ld + slots * FFMA_BN * ld
              + FFMA_BM * (FFMA_BN + FFMA_PAD_P) + 2 * FFMA_BM)
    return FfmaTile(FFMA_BM, FFMA_BN, FFMA_THREADS, slots, 4 * floats)


@dataclasses.dataclass(frozen=True)
class WgmmaTile:
    bm: int             # query rows of a block
    bn: int             # keys of a K/V tile
    stages: int         # K/V ring slots
    threads: int        # threads of a block
    swizzle_bytes: int  # a shared-memory row: the swizzle span
    box_cols: int       # columns of a TMA box (a column atom)
    smem_bytes: int     # dynamic shared memory of a block


def wgmma_tile(head_dim: int) -> WgmmaTile:
    """The ``wgmma`` design's tile at ``head_dim``, mirroring ``Cfg<D>`` of
    ``csrc/flash_attention_wgmma.cu``: a row of a swizzle atom holds
    min(D, 64) bf16 columns; shared memory is Q, the K and V ring and one
    mbarrier for Q plus two a stage, from a base aligned up to 1024
    bytes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one of {HEAD_DIMS}")
    bn, stages = WGMMA_BN[head_dim], WGMMA_STAGES[head_dim]
    cols = min(head_dim, 64)
    row = 2 * head_dim  # bytes of a Q/K/V row, all column atoms
    smem = (WGMMA_BM * row + 2 * stages * bn * row
            + (1 + 2 * stages) * 8 + 1024)
    threads = 256 if head_dim == 256 else 384
    return WgmmaTile(WGMMA_BM, bn, stages, threads, 2 * cols, cols, smem)


def _library(name: str):
    fn = _bound.get(name)
    if fn is not None:
        return fn
    source, symbol = LIBRARIES[name]
    fn = getattr(build.load(source), symbol)
    fn.restype = ctypes.c_int
    if name == "wgmma":
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,                                    # o
            ctypes.POINTER(ctypes.c_longlong),                  # 9 TMA strides
            ctypes.POINTER(ctypes.c_longlong),                  # 3 o strides
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, H, KV
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # Sq, Sk, D
            ctypes.c_int, ctypes.c_int,                         # causal, window
            ctypes.c_float,                                     # softcap
            ctypes.c_void_p,                                    # stream
        ]
    else:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,                                    # o
            ctypes.POINTER(ctypes.c_longlong),                  # 12 strides
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, H, KV
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # Sq, Sk, D
            ctypes.c_int, ctypes.c_int,                         # causal, window
            ctypes.c_float,                                     # softcap
            ctypes.c_void_p,                                    # stream
        ]
    _bound[name] = fn
    return fn


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """``q [B,H,Sq,D]``, ``k``/``v [B,KV,Sk,D]``: dims, dtype, device and
    the unit stride on D that both attention kernels need."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last dim")
    b, h, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v must be [{b}, KV, S, {d}], got {tuple(k.shape)}"
        )
    kv = k.shape[1]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {q.device} are not supported")


def kernel_strides(*tensors: torch.Tensor, dims: int = 3) -> list[int]:
    """The first ``dims`` element strides of each tensor (0 for a dim of
    size 1, whose stride is never used); raises unless every one keeps the
    16-byte row alignment of the kernels' vector loads."""
    out = []
    for t in tensors:
        pack = 16 // t.element_size()
        if t.data_ptr() % 16:
            raise ValueError("attention operands must start 16-byte aligned")
        for n, s in zip(t.shape[:dims], t.stride()[:dims]):
            s = s if n > 1 else 0
            if s % pack:
                raise ValueError(
                    f"stride {s} of a {tuple(t.shape)} operand is not a "
                    f"multiple of {pack} elements (16 bytes)"
                )
            out.append(s)
    return out


def tensor_map_strides(t: torch.Tensor) -> list[int]:
    """Byte strides of S, heads and B of a ``[B, heads, S, D]`` operand, as
    its 4-D tensor map (D, S, heads, B) takes them: element
    ``t[b, h, s, d]`` lies at ``data_ptr + d·esize + s·st[0] + h·st[1] +
    b·st[2]``.

    A dim of size 1 is only ever addressed at 0, and its stride may be
    anything (``kernel_strides`` writes 0); a tensor map needs a positive
    multiple of 16 bytes there, so it gets the stride a contiguous layout
    would have. Raises unless every stride is a positive multiple of 16
    bytes below 2^40 (a broadcast dim, stride 0 and size > 1, cannot be
    described to TMA)."""
    _, _, _, d = t.shape
    esize = t.element_size()
    strides, contiguous = [], d * esize
    for n, st in ((t.shape[2], t.stride(2)), (t.shape[1], t.stride(1)),
                  (t.shape[0], t.stride(0))):
        byte = st * esize if n > 1 else contiguous
        if byte <= 0 or byte % 16 or byte >= MAX_TMA_STRIDE:
            raise ValueError(
                f"a {tuple(t.shape)} operand with strides {t.stride()} has "
                f"a byte stride {byte} that a tensor map cannot take (a "
                "positive multiple of 16 below 2^40)"
            )
        strides.append(byte)
        contiguous = byte * n
    return strides


def flash_attention(
    q: torch.Tensor,   # [B, H, Sq, D]
    k: torch.Tensor,   # [B, KV, Sk, D]
    v: torch.Tensor,   # [B, KV, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    check_heads(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap
        )
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit {MAX_GRID_Y}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    out = out.transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = kernel_strides(q, k, v, out)
    name = design(q.dtype, d)
    if name == "wgmma":
        tma = [st for t in (q, k, v) for st in tensor_map_strides(t)]
        args = [(ctypes.c_longlong * 9)(*tma),
                (ctypes.c_longlong * 3)(*strides[9:])]
    else:
        args = [(ctypes.c_longlong * 12)(*strides)]
    tail = [b, h, kv, sq, sk, d, int(causal), window or 0, float(softcap or 0.0)]
    fn = _library(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *args, *tail, stream)
    _launches[name] += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention ({name}) kernel launch failed: error {err} "
            f"(q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype}; a "
            "negative code is a refused tensor map)"
        )
    return out
