"""Dtype-discipline lint for pricing paths.

The port's own copy of the JAX package's ``analysis/dtypes.py``, over the
port's pricing modules. The rule it guards is the reference's: on every
path that prices a design — simulator, router, categories, the torch
rollout engine, designer, FMMD/mixing/SCA — **all priced quantities are
float64, all index arrays are int64**. A single float32 tensor perturbs
makespans enough to break the rtol=1e-9 parity with the numpy engines;
an int32 index array overflows silently at the 5000-agent scale.

Scanned: ``net/`` plus the pricing modules of ``core/`` (the learning
half — gossip/dpsgd/compression — legitimately trades in float32 and
bfloat16 and is out of scope).

``narrow-float-dtype``   np float32/float16/half/single references, and
                         torch's float32/float16/bfloat16/complex64 with
                         their aliases ``torch.float``/``torch.half``/
                         ``torch.cfloat``
``narrow-int-dtype``     np int32/int16/int8/uint* references, and
                         torch's int32/int16/int8/uint* with the aliases
                         ``torch.int``/``torch.short``
``narrow-dtype-string``  "float32"/"single"/"int32"/"f4"/"i4"… string
                         dtype literals in array constructors/casts,
                         including the method spellings
                         ``.astype("float32")`` / ``.view("float32")``
``implicit-torch-dtype`` dtype-less ``torch.zeros``/``ones``/``empty``/
                         ``full``/``arange``/``linspace``/``tensor`` —
                         numpy defaults to float64, torch to float32
                         (``torch.get_default_dtype()``) whatever the
                         data, so an implicit torch dtype silently
                         narrows a priced quantity. ``torch.as_tensor``
                         and ``torch.from_numpy`` keep their source's
                         dtype and are exempt.

The reference's ``implicit-jnp-dtype`` is this rule for ``jnp`` constructors
(jax narrows unless x64 is on); torch has no such switch, so its rule
covers every constructor that can default to float32.
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.common import (
    Finding,
    ScopedVisitor,
    dotted_name,
    iter_python_files,
    parse_file,
    rel,
)

CHECKER = "dtypes"

# Pricing paths: the whole network stack plus core's design/pricing
# modules. core/gossip.py, core/dpsgd.py and runtime/compression.py
# are the *learning* half (float32 wire formats are intentional there).
SCAN_DIRS = [
    "src/repro_torch/net",
    "src/repro_torch/core/designer.py",
    "src/repro_torch/core/fmmd.py",
    "src/repro_torch/core/mixing.py",
    "src/repro_torch/core/sca.py",
    "src/repro_torch/core/topology_baselines.py",
    "src/repro_torch/core/weight_opt.py",
]

_NARROW_FLOAT = {"float32", "float16", "half", "single", "longdouble"}
_NARROW_INT = {
    "int32", "int16", "int8", "uint8", "uint16", "uint32", "uint64",
    "short", "intc",
}
# torch's names: its aliases differ from numpy's (``torch.float`` is
# float32 where numpy's ``float`` was float64; ``torch.int`` is int32).
_TORCH_NARROW_FLOAT = {
    "float32", "float16", "bfloat16", "half", "float", "complex64",
    "cfloat", "chalf", "complex32",
}
_TORCH_NARROW_INT = {
    "int32", "int16", "int8", "uint8", "uint16", "uint32", "uint64",
    "int", "short",
}
_NARROW_STRINGS = {
    "float32", "float16", "half", "single", "f4", "f2", "<f4", "<f2",
    "int32", "int16", "int8", "i4", "i2", "i1",
    "<i4", "<i2", "uint8", "uint16", "uint32", "u4",
}
# ``view``/``astype`` are *method* spellings of a cast — narrowing via
# ``x.view("float32")`` is the same violation as ``np.float32(x)``.
_ARRAY_CTORS = {
    "array", "asarray", "zeros", "ones", "empty", "full", "arange",
    "astype", "view", "dtype", "frombuffer", "fromiter",
}
# torch constructors whose *implicit* dtype is torch's default float32 (or,
# for integer data, one the data picks) rather than numpy's float64 —
# these must spell dtype= on pricing paths (torch takes it by keyword
# only).
_TORCH_DEFAULT_CTORS = {
    "zeros", "ones", "empty", "full", "arange", "linspace", "tensor",
}


def _narrow_sets(chain: str | None) -> tuple[set[str], set[str]]:
    """(narrow float names, narrow int names) of the module ``chain``
    reads a dtype from: numpy's, or torch's for ``torch.<name>``."""
    head = chain.split(".", 1)[0] if chain else None
    if head in ("np", "numpy"):
        return _NARROW_FLOAT, _NARROW_INT
    if head == "torch" and chain.count(".") == 1:
        return _TORCH_NARROW_FLOAT, _TORCH_NARROW_INT
    return set(), set()


class _Visitor(ScopedVisitor):
    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.findings: list[Finding] = []

    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        self.findings.append(Finding(
            checker=CHECKER, path=self.path,
            line=getattr(node, "lineno", 0), scope=self.scope,
            code=code, message=message,
        ))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        chain = dotted_name(node)
        narrow_float, narrow_int = _narrow_sets(chain)
        leaf = chain.rsplit(".", 1)[-1] if chain else None
        if leaf in narrow_float:
            self._emit(
                node, "narrow-float-dtype",
                f"{chain} on a pricing path — every priced quantity "
                "is float64 (parity with the numpy engines depends on it)",
            )
        elif leaf in narrow_int:
            self._emit(
                node, "narrow-int-dtype",
                f"{chain} on a pricing path — index arrays are "
                "int64 (int32 dense link ids overflow at the "
                "5000-agent scale)",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        leaf = None
        if isinstance(func, ast.Attribute):
            leaf = func.attr
        elif isinstance(func, ast.Name):
            leaf = func.id
        if leaf in _ARRAY_CTORS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if (
                    isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value in _NARROW_STRINGS
                ):
                    self._emit(
                        arg, "narrow-dtype-string",
                        f"dtype string {arg.value!r} on a pricing path — "
                        "use np.float64 / np.int64 explicitly",
                    )
        chain = dotted_name(func) if isinstance(func, ast.Attribute) \
            else None
        if chain and chain.count(".") == 1 and chain.startswith("torch.") \
                and chain.split(".")[1] in _TORCH_DEFAULT_CTORS \
                and not any(kw.arg == "dtype" for kw in node.keywords):
            self._emit(
                node, "implicit-torch-dtype",
                f"{chain}(...) without dtype= on a pricing path — torch "
                "defaults to float32 (or a dtype the data picks); spell "
                "dtype=torch.float64 / torch.int64",
            )
        self.generic_visit(node)


def check(root: Path) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_python_files(root, SCAN_DIRS):
        tree = parse_file(path)
        if tree is None:
            continue
        visitor = _Visitor(rel(path, root))
        visitor.visit(tree)
        findings.extend(visitor.findings)
    return findings
