"""Blocked online-softmax attention (prefill) on Hopper.

Counterpart of the JAX package's ``kernels/flash_attention.py``: causal,
sliding-window, logit softcap, GQA, forward only, over one CUDA kernel
(``csrc/flash_attention.cu``: ``mma.sync`` for bfloat16, full-precision
FFMA for float32). Same signature as the TPU kernel's entry point minus
its block sizes: any ``Sq``/``Sk`` is accepted.

Operands are ``[B, H, S, D]`` tensors of any element strides with unit
stride on D (``D`` ∈ {16, 32, 64, 128, 256}), so the model passes its
``[B, S, H, D]`` activations as ``x.transpose(1, 2)`` views. The output
is ``[B, H, Sq, D]``, laid out in memory as ``[B, Sq, H, D]`` (a
transposed view of a contiguous tensor) so that the model reshapes it to
``[B, Sq, H·D]`` without a copy.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``; a
CUDA tensor launches the kernel or raises (also when the build fails).
Every launch adds one to ``launch_count()``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GRID_Y = 65535

_launches = 0
_bound = None


def launch_count() -> int:
    """Kernel launches made by this module's wrapper so far."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library():
    global _bound
    if _bound is None:
        fn = build.load("flash_attention").repro_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
            ctypes.c_void_p,                                    # o
            ctypes.POINTER(ctypes.c_longlong),                  # 12 strides
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, H, KV
            ctypes.c_int, ctypes.c_int, ctypes.c_int,           # Sq, Sk, D
            ctypes.c_int, ctypes.c_int,                         # causal, window
            ctypes.c_float,                                     # softcap
            ctypes.c_int,                                       # dtype code
            ctypes.c_void_p,                                    # stream
        ]
        _bound = fn
    return _bound


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """``q [B,H,Sq,D]``, ``k``/``v [B,KV,Sk,D]``: dims, dtype, device and
    the unit stride on D that both attention kernels need."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPE_CODE:
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


def flash_attention(
    q: torch.Tensor,   # [B, H, Sq, D]
    k: torch.Tensor,   # [B, KV, Sk, D]
    v: torch.Tensor,   # [B, KV, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    global _launches
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
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 12)(*strides),
            b, h, kv, sq, sk, d, int(causal), window or 0,
            float(softcap or 0.0), DTYPE_CODE[q.dtype], stream,
        )
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err} "
            f"(q={tuple(q.shape)}, k={tuple(k.shape)}, {q.dtype})"
        )
    return out
