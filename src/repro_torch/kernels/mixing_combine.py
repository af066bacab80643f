"""Fused gossip-combine + SGD update (the paper's hot loop) on Hopper.

Counterpart of the JAX package's ``kernels/mixing_combine.py``. Each
D-PSGD iteration ends with

    x_i ← W_ii·x_i + Σ_{j∈N(i)} W_ij·x_j − η·g_i                (eq. (2))

Two entry points over one CUDA kernel (``csrc/mixing_combine.cu``):

* ``mixing_sgd_combine(x, recv, weights, momentum, lr=)`` — one agent,
  the neighbours' shards delivered in ``recv[R, N]``; same signature and
  semantics as the TPU kernel, minus its ``block_n`` (any N is accepted,
  the ragged tail is handled inside the kernel). With ``momentum=None``
  (and no ``lr``) it is the mix alone, ``W_ii·x + Σ_r W_ir·recv[r]``:
  what the gossip across ranks (``core/gossip.mix_sparse_p2p``) launches
  on each rank once the neighbours' shards have arrived.
* ``mixing_sgd_combine_stacked(x, idx, weights, g, lr=)`` — all agents
  of one card at once, ``x[A, N]``; agent a's r-th neighbour is the row
  ``x[idx[a, r]]`` read in place, so no ``recv`` buffer is materialised.
  This is what the D-PSGD step launches, once per parameter leaf. With
  ``g=None`` (and no ``lr``) it is the mix alone, ``Σ_j W_aj·x[j]``,
  from an instantiation of the kernel that reads no gradient: the
  launcher's ``sparse`` gossip (``launch/train.py``) mixes parameters
  that ``optim.sgd`` has already updated.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``; a
CUDA tensor launches the kernel or raises (also when the build fails).
Every launch adds one to ``launch_count()``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NO_G = -1  # g_dtype of the launch without a gradient term (g is NULL)

_launches = 0
_bound = None


def launch_count() -> int:
    """Kernel launches made by this module's wrappers so far."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library():
    global _bound
    if _bound is None:
        lib = build.load("mixing_combine")
        fn = lib.repro_mixing_sgd_combine
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,    # x
            ctypes.c_void_p,    # nbr
            ctypes.c_void_p,    # idx (NULL for the per-agent form)
            ctypes.c_void_p,    # weights
            ctypes.c_void_p,    # g
            ctypes.c_void_p,    # out
            ctypes.c_longlong,  # rows
            ctypes.c_longlong,  # n
            ctypes.c_int,       # r
            ctypes.c_float,     # lr
            ctypes.c_int,       # x dtype code
            ctypes.c_int,       # g dtype code, _NO_G without g
            ctypes.c_void_p,    # stream
        ]
        _bound = fn
    return _bound


def _check_lr(lr) -> float:
    if isinstance(lr, torch.Tensor):
        raise TypeError(
            "lr must be a Python float: read a scheduled learning rate on "
            "the host once per step, the kernel takes it by value"
        )
    return float(lr)


def _check_operands(x, others: dict, g_name: str, g) -> None:
    """Device, dtype and contiguity of the float operands (``g`` may be
    None: the mix without a gradient term)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if g is not None and g.dtype != x.dtype and g.dtype != torch.float32:
        raise TypeError(
            f"{g_name} must be float32 or the dtype of x ({x.dtype}), "
            f"got {g.dtype}"
        )
    if g is not None:
        others = {g_name: g, **others}
    for name, t in {"x": x, **others}.items():
        if t.device != x.device:
            raise ValueError(
                f"{name} is on {t.device}, x is on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, nbr, idx, weights, g, rows: int, n: int, r: int, lr: float):
    """Allocate ``out`` and launch on the current stream (no sync)."""
    global _launches
    fn = _library()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), nbr.data_ptr(),
            idx.data_ptr() if idx is not None and r > 0 else None,
            weights.data_ptr(), None if g is None else g.data_ptr(),
            out.data_ptr(), rows, n, r, lr,
            _DTYPE_CODE[x.dtype],
            _NO_G if g is None else _DTYPE_CODE[g.dtype], stream,
        )
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"mixing_sgd_combine kernel launch failed: cudaError {err} "
            f"(rows={rows}, n={n}, r={r}, x={x.dtype}, "
            f"g={None if g is None else g.dtype})"
        )
    return out


def mixing_sgd_combine(
    x: torch.Tensor,         # [N] own parameters (flat shard)
    recv: torch.Tensor,      # [R, N] received neighbour shards, R ≥ 0
    weights: torch.Tensor,   # [R+1]: [W_ii, W_i,j1, ..., W_i,jR]
    momentum: torch.Tensor | None = None,  # [N], or None: the mix alone
    *,
    lr: float | None = None,  # the step on momentum; given exactly with it
) -> torch.Tensor:
    if (momentum is None) != (lr is None):
        raise TypeError(
            "lr scales momentum: pass both (the fused update) or neither "
            "(the mix)"
        )
    lr = 0.0 if momentum is None else _check_lr(lr)
    if x.dim() != 1:
        raise ValueError(f"x must be [N], got {tuple(x.shape)}")
    n = x.shape[0]
    if recv.dim() != 2 or recv.shape[1] != n:
        raise ValueError(
            f"recv must be [R, {n}], got {tuple(recv.shape)}"
        )
    r = recv.shape[0]
    if tuple(weights.shape) != (r + 1,):
        raise ValueError(
            f"weights must be [{r + 1}], got {tuple(weights.shape)}"
        )
    if momentum is not None and tuple(momentum.shape) != (n,):
        raise ValueError(
            f"momentum must be [{n}], got {tuple(momentum.shape)}"
        )
    if recv.dtype != x.dtype:
        raise TypeError(f"recv is {recv.dtype}, x is {x.dtype}")
    _check_operands(
        x, {"recv": recv, "weights": weights}, "momentum", momentum
    )
    if x.device.type == "cpu":
        return ref.mixing_sgd_combine_ref(x, recv, weights, momentum, lr=lr)
    w32 = weights.to(torch.float32)
    return _launch(x, recv, None, w32, momentum, 1, n, r, lr)


def mixing_sgd_combine_stacked(
    x: torch.Tensor,        # [A, N] parameters of all agents (one leaf)
    idx: torch.Tensor,      # int32 [A, R] neighbour rows, R ≥ 0
    weights: torch.Tensor,  # fp32 [A, R+1]: [:, 0] = W_aa
    g: torch.Tensor | None = None,  # [A, N] gradients, or None: mix alone
    *,
    lr: float | None = None,  # the step on g; given exactly when g is
) -> torch.Tensor:
    if (g is None) != (lr is None):
        raise TypeError(
            "lr scales g: pass both (the fused update) or neither (the mix)"
        )
    lr = 0.0 if g is None else _check_lr(lr)
    if x.dim() != 2:
        raise ValueError(f"x must be [A, N], got {tuple(x.shape)}")
    a, n = x.shape
    if idx.dim() != 2 or idx.shape[0] != a:
        raise ValueError(f"idx must be [{a}, R], got {tuple(idx.shape)}")
    r = idx.shape[1]
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if tuple(weights.shape) != (a, r + 1):
        raise ValueError(
            f"weights must be [{a}, {r + 1}], got {tuple(weights.shape)}"
        )
    if g is not None and g.shape != x.shape:
        raise ValueError(
            f"g must be {tuple(x.shape)}, got {tuple(g.shape)}"
        )
    _check_operands(x, {"idx": idx, "weights": weights}, "g", g)
    if x.device.type == "cpu":
        if r and not bool(((idx >= 0) & (idx < a)).all()):
            raise ValueError(f"idx entries must lie in [0, {a})")
        return ref.mixing_sgd_combine_stacked_ref(x, idx, weights, g, lr=lr)
    # The range of idx is checked where the table is built, on the host
    # (gossip.neighbor_table); reading it back here would synchronise.
    return _launch(x, x, idx, weights, g, a, n, r, lr)
