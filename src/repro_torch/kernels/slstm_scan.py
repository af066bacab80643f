"""sLSTM's recurrence (xLSTM's scalar-memory block), forward and backward,
on Hopper.

Replaces no TPU kernel: the JAX package steps the cell with XLA's
``jax.lax.scan``. Each step adds the rounded recurrent product
``round(round(h_{t-1}) @ R)`` to the step's input projections and applies
the cell's exponential gating (``ref.slstm_step_ref``); the whole loop
over S runs in one launch a layer (``csrc/slstm_scan.cu``: one block a
row, ``d`` even and ``≤ 1024``). ``pre_x [B, S, 4·d]`` and the carry ``{c, n, h, m}``
``[B, d]`` are float32; ``r [d, 4·d]`` is in the compute dtype (float32 or
bfloat16), whose rounding is part of the function. Three entry points:

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
raises (also when the build fails).
Every launch adds one to ``launch_count()`` and to its direction's entry
of ``launch_count_by_design()``. A fake CUDA tensor (``compat.is_fake``,
the dry run) gets what the launch allocates, the saved tensors included,
and launches nothing: the call adds one to ``fake_calls_by_design()`` and
its FLOPs (``work``) to ``fake_flops()``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import compat
from repro_torch.kernels import build, ref

DESIGNS = ("forward", "backward")
MAX_D = 1024          # kMaxThreads × 8 columns / 4 gates in the .cu
CARRY = ("c", "n", "h", "m")
# FLOPs of a (token, element) beside the recurrent product's 2 a (k,
# column): the forward's cell (the rounding's add, tanh, sigmoid,
# log-sigmoid, the stabilizer and the update, 20 counting each
# transcendental as one), the backward's reverse cell (40).
FWD_CELL_FLOPS, BWD_CELL_FLOPS = 20, 40
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_launches = dict.fromkeys(DESIGNS, 0)
_fake = {"calls": dict.fromkeys(DESIGNS, 0), "flops": 0}
_bound: dict[str, object] = {}


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
    read once (r once, though the kernel streams it every step) and each
    output written once — forward: pre_x, r and the carry in, hs and the
    carry out (and, when ``saved``, the pre-activations and (c, n, m) of
    every step); backward: the saved tensors, r, the carry, hs's and the
    last carry's gradients in, dpre and the carry's gradient out."""
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


def _library(name: str):
    fn = _bound.get(name)
    if fn is not None:
        return fn
    lib = build.load("slstm_scan")
    if name == "forward":
        fn = lib.repro_slstm_scan_fwd
        pointers = 7      # pre_x, R, carry0, hs, carry, pre_save, st_save
    else:
        fn = lib.repro_slstm_scan_bwd
        pointers = 8      # pre, st, R, carry0, dhs, dlast, dpre, dcarry0
    fn.restype = ctypes.c_int
    fn.argtypes = [*[ctypes.c_void_p] * pointers,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, S, d
                   ctypes.c_int,                              # r dtype
                   ctypes.c_void_p]                           # stream
    _bound[name] = fn
    return fn


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
    """``t`` contiguous and starting on 16 bytes (the kernels' vector
    loads)."""
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
    fn = _library("forward")
    with torch.cuda.device(pre_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pre_x.data_ptr(), r.data_ptr(), carry0.data_ptr(),
                 hs.data_ptr(), last.data_ptr(),
                 None if saved is None else saved[0].data_ptr(),
                 None if saved is None else saved[1].data_ptr(),
                 b, s, d, _DTYPE_CODE[r.dtype], stream)
    _launches["forward"] += 1
    if err != 0:
        raise RuntimeError(
            f"slstm_scan forward launch failed: cudaError {err} "
            f"(pre_x={tuple(pre_x.shape)}, r={r.dtype})")
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
    fn = _library("backward")
    with torch.cuda.device(pre.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pre.data_ptr(), states.data_ptr(), r.data_ptr(),
                 c0.data_ptr(), dhs.data_ptr(),
                 None if dl is None else dl.data_ptr(), dpre.data_ptr(),
                 dcarry0.data_ptr(), b, s, d, _DTYPE_CODE[r.dtype], stream)
    _launches["backward"] += 1
    if err != 0:
        raise RuntimeError(
            f"slstm_scan backward launch failed: cudaError {err} "
            f"(pre={tuple(pre.shape)}, r={r.dtype})")
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
