"""Trace lint — dispatch-level proof of the pricing path's contracts.

The port's counterpart of the JAX package's ``analysis/tracelint.py``.
The torch rollout engine's load-bearing properties — float64 on every
priced quantity, and a host-synchronisation count (``torch_engine.
sync_count()``) that sees every device→host read — are docstring claims
that runtime parity tests check only indirectly. This checker makes them
lint invariants by *running* every registered entry point
(``tracelint_targets.py``, a per-tree registry of ``TraceTarget``\\ s with
concrete small-instance argument factories) under a
``torch.utils._python_dispatch.TorchDispatchMode`` that records every aten
op the call dispatches (``OpRecord``): on CPU tensors here, on CUDA
tensors on the card (``chip_smoke.py``'s ``tracelint`` phase).

Dispatch-level sub-checks:

``narrow-float-in-trace``   an op on the pricing path outputs float16,
                            bfloat16, float32 or complex64 (any float or
                            complex narrower than 64 bits) — a silent
                            narrowing that the AST ``dtypes`` checker
                            structurally cannot see (e.g. a Python float
                            wrapped at torch's default dtype).
``uncounted-host-sync``     the device→host reads the mode sees differ
                            from the rise of ``torch_engine.sync_count()``
                            over the call. A device→host read is an
                            ``aten._local_scalar_dense`` (what ``.item()``,
                            ``bool()``, ``int()``, ``float()`` and an
                            ``if`` on a tensor dispatch), an
                            ``aten._to_copy`` to the CPU (``.cpu()``,
                            ``.to("cpu")``), an ``aten.copy_`` into a CPU
                            tensor, or an op whose output size depends on
                            the data (``nonzero``, ``masked_select``,
                            ``unique``, a boolean index), of a tensor that
                            lies on the card or, in a run on the CPU, that
                            an op of the call computed. On the H100 (torch
                            2.11) ``.item()`` and ``bool()`` of a CUDA
                            tensor dispatch ``aten._local_scalar_dense.
                            default`` and ``.cpu()`` dispatches
                            ``aten._to_copy.default`` with
                            ``device=cpu`` (``chip_smoke.py``'s
                            ``tracelint`` phase prints the ops it saw for
                            each); on the CPU ``.cpu()`` of a CPU tensor
                            dispatches nothing, which is why the engine
                            copies its results with ``.to("cpu",
                            copy=True)``.
``op-budget-exceeded``      the aten ops a target dispatches (max over its
                            cases) outgrew its budget in
                            ``tracelint_manifest.txt`` — the tripwire for
                            an accidental unrolling or a loop that runs
                            more rounds than it should.
``sync-budget-exceeded``    the same for its device→host reads.
``missing-budget``          a registered target has no manifest entry.
``stale-budget-entry``      a manifest entry names no registered target.
``malformed-budget``        a manifest line that does not parse.
``trace-error``             a registered case failed to build or run (the
                            registry itself is broken).
``targets-import-error``    the registry module failed to load.

AST sub-pass over ``SYNC_SCAN_DIRS`` (``net/`` and
``core/priced_training.py``): starting from the engine's device entry
(``_run_batch``), the transitive module-local call closure is the device
half. Within it, a name holds a tensor when an assignment gives it the
value of a torch call, a tensor method, arithmetic or a comparison on a
tensor, an index into one, or a closure function returning one; a
parameter holds one when a call site in the closure passes one.

``implicit-host-sync``      ``.item()``, ``.tolist()``, ``.cpu()``,
                            ``.numpy()``, ``.to("cpu")``, or ``bool``/
                            ``int``/``float`` of a tensor, or an
                            ``if``/``while``/``assert``/ternary/``not``/
                            ``and``/``or`` on one — a device→host read.
                            A read is counted, and exempt, when the
                            statement just before it in its block adds 1
                            to the engine's counter (``_syncs += 1``): so
                            ``_read_any`` and the results copy in
                            ``_run_batch``.

The reference's ``host-callback`` and ``multiple-launches`` have no
counterpart: in eager mode every aten op is a launch of its own, so the op
budget stands in for "one launch". ``narrow-float-literal``,
``closure-captured-array``, ``unhashable-static-arg`` and
``count_compilations`` have none either: nothing is traced or compiled,
so there is no literal or constant baked into a program and no cache to
retrace — a Python float reaches an op as a wrapped scalar, whose dtype
``narrow-float-in-trace`` sees on the op's output. Nor is there a
jax-absent skip: torch is the port's own dependency.

``collect_metrics`` reads, at each target's first case, the aten ops and
device→host reads a call dispatches, and for ``rollout-batch`` those that
``_waterfill`` dispatches per water-fill round (``waterfill_ops_per_round``,
``waterfill_host_reads_per_round``, ``waterfill_output_bytes_per_round``)
— the numbers a fused water-filling kernel would take away.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import importlib.util
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.common import (
    Finding,
    _Caught,
    dotted_name,
    iter_python_files,
    parse_file,
    rel,
    repo_root,
)

CHECKER = "tracelint"

TARGETS_REL_PATH = "src/repro_torch/analysis/tracelint_targets.py"
MANIFEST_REL_PATH = "src/repro_torch/analysis/tracelint_manifest.txt"
MANIFEST_FILENAME = "tracelint_manifest.txt"

# The sync-critical surface: the device engine itself plus the pricing
# loop that drives it (the reference's RETRACE_SCAN_DIRS).
SYNC_SCAN_DIRS = [
    "src/repro_torch/net",
    "src/repro_torch/core/priced_training.py",
]
# Module-level defs whose call closure is the device half: the engine's
# one device entry.
SYNC_SEEDS = ("_run_batch",)
# Module-level counters a counted read increments just before it.
SYNC_COUNTERS = ("_syncs",)

_WIDE = (torch.float64, torch.complex128)
# Ops whose output size depends on the data: the host waits for the
# device to learn it.
_DATA_DEPENDENT = {
    "aten.nonzero.default", "aten.masked_select.default",
    "aten._unique.default", "aten._unique2.default",
    "aten.unique_dim.default", "aten.unique_consecutive.default",
    "aten.repeat_interleave.Tensor",
}


# ---------------------------------------------------------------------------
# Target registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceCase:
    """One concrete shape point of a target: ``make(device)`` returns the
    ``(fn, args)`` pair whose call ``fn(*args)`` is recorded — ``fn`` is the
    entry exactly as the host path calls it, its tensors on ``device``."""

    label: str
    make: Callable[[torch.device], tuple[Callable, tuple]]


@dataclasses.dataclass(frozen=True)
class TraceTarget:
    """A registered entry point of the pricing path.

    ``name`` keys the budget manifest; ``path``/``scope`` anchor findings
    (and waiver keys) at the entry the target certifies.
    """

    name: str
    path: str
    scope: str
    cases: tuple[TraceCase, ...]


_TARGETS_CACHE: dict[Path, Any] = {}


def _load_targets(root: Path) -> tuple[tuple[TraceTarget, ...], list[Finding]]:
    path = (root / TARGETS_REL_PATH).resolve()
    if not path.is_file():
        return (), []
    mod = _TARGETS_CACHE.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"_torch_tracelint_targets_{len(_TARGETS_CACHE)}", path
        )
        mod = importlib.util.module_from_spec(spec)
        # registry code is arbitrary: any failure is the finding
        with _Caught(Exception) as caught:
            spec.loader.exec_module(mod)
        if caught.error is not None:
            return (), [Finding(
                checker=CHECKER, path=TARGETS_REL_PATH, line=1,
                scope="<module>", code="targets-import-error",
                message=(
                    f"target registry failed to import: {caught.error!r} "
                    "— the dispatch pass has nothing to certify until it "
                    "loads"
                ),
            )]
        _TARGETS_CACHE[path] = mod
    targets = getattr(mod, "TARGETS", None)
    if not targets:
        return (), [Finding(
            checker=CHECKER, path=TARGETS_REL_PATH, line=1,
            scope="<module>", code="targets-import-error",
            message=(
                "target registry defines no TARGETS tuple — register "
                "every pricing entry point (see TraceTarget)"
            ),
        )]
    return tuple(targets), []


# ---------------------------------------------------------------------------
# Budget manifest
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BudgetEntry:
    name: str
    max_ops: int
    max_syncs: int
    line: int


def load_manifest(path: Path) -> tuple[dict[str, BudgetEntry], list[Finding]]:
    """``<target-name> <max-ops> <max-syncs>`` per line; ``#`` comments."""
    budgets: dict[str, BudgetEntry] = {}
    findings: list[Finding] = []
    if not path.is_file():
        return budgets, findings
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        fields = line.split()
        if len(fields) != 3 or not fields[1].isdigit() \
                or not fields[2].isdigit() or fields[0] in budgets:
            why = "duplicate target" if len(fields) == 3 \
                and fields[0] in budgets \
                else "expected '<target> <max-ops> <max-syncs>'"
            findings.append(Finding(
                checker=CHECKER, path=path.name, line=lineno,
                scope="<module>", code="malformed-budget",
                message=f"cannot use manifest line {raw!r}: {why}",
            ))
            continue
        budgets[fields[0]] = BudgetEntry(
            fields[0], int(fields[1]), int(fields[2]), lineno)
    return budgets, findings


# ---------------------------------------------------------------------------
# The dispatch record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpRecord:
    """What one recorded call dispatched.

    ``ops`` counts aten ops by overload name; ``narrow`` counts the ops
    that output a narrow float or complex, by ``(op, dtype)``;
    ``host_reads`` counts device→host reads by op; ``counted`` is the
    rise of ``torch_engine.sync_count()`` over the call; ``regions`` holds
    ``[ops, host reads, output bytes]`` dispatched inside each watched
    function; ``seconds`` is the call's host time under the mode."""

    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    narrow: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    host_reads: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    counted: int = 0
    regions: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def total_ops(self) -> int:
        return sum(self.ops.values())

    @property
    def total_host_reads(self) -> int:
        return sum(self.host_reads.values())


def _is_narrow(t: torch.Tensor) -> bool:
    return (t.dtype.is_floating_point or t.dtype.is_complex) \
        and t.dtype not in _WIDE


class _Recorder(TorchDispatchMode):
    """Records every aten op into an ``OpRecord``. A device→host read is
    one of a device value: on a run on the card, a tensor on the card; on
    a run on the CPU, a tensor that an op of the call computed (what the
    card would hold — tensors the host hands in, by ``torch.from_numpy``,
    are not; a host-side op on one is, as the CPU cannot tell the two
    apart)."""

    def __init__(self, record: OpRecord, device: torch.device) -> None:
        super().__init__()
        self.record = record
        self.on_cpu = device.type == "cpu"
        # id -> tensor, weakly: identity, not ``Tensor.__eq__``
        self.computed: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()
        self.active: list[str] = []

    def _device_value(self, t: Any) -> bool:
        if not isinstance(t, torch.Tensor):
            return False
        if not self.on_cpu:
            return t.device.type not in ("cpu", "meta")
        return self.computed.get(id(t)) is t

    def _host_read(self, name: str, args, kwargs) -> bool:
        if name == "aten._local_scalar_dense.default" \
                or name in _DATA_DEPENDENT:
            return self._device_value(args[0])
        if name == "aten._to_copy.default":
            dest = kwargs.get("device")
            return dest is not None and torch.device(dest).type == "cpu" \
                and self._device_value(args[0])
        if name.startswith("aten.copy_."):
            return isinstance(args[0], torch.Tensor) \
                and args[0].device.type == "cpu" \
                and self._device_value(args[1])
        if name == "aten.index.Tensor":
            return any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                and self._device_value(i) for i in args[1])
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        read = self._host_read(name, args, kwargs)
        out = func(*args, **kwargs)
        rec = self.record
        rec.ops[name] += 1
        if read:
            rec.host_reads[name] += 1
        nbytes = 0
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                if self.on_cpu:
                    self.computed[id(t)] = t
                nbytes += t.numel() * t.element_size()
                if _is_narrow(t):
                    rec.narrow[(name, str(t.dtype))] += 1
        for region in self.active:
            counts = rec.regions.setdefault(region, [0, 0, 0])
            counts[0] += 1
            counts[1] += int(read)
            counts[2] += nbytes
        return out


class _Watched:
    """``with _Watched(recorder, [(module, name), ...]):`` wraps each
    function ``module.name`` so that the ops it dispatches also count
    under ``name`` in the record, and puts the originals back after."""

    def __init__(self, recorder: _Recorder,
                 watch: Iterable[tuple[Any, str]]) -> None:
        self.recorder = recorder
        self.watch = tuple(watch)
        self.saved: list[tuple[Any, str, Callable]] = []

    def _wrap(self, name: str, fn: Callable) -> Callable:
        active = self.recorder.active

        def watched(*args, **kwargs):
            active.append(name)
            out = fn(*args, **kwargs)
            active.pop()
            return out

        return watched

    def __enter__(self) -> "_Watched":
        for module, name in self.watch:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc) -> bool:
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved.clear()
        return False


def trace(fn: Callable, args: tuple, device: str | torch.device = "cpu",
          watch: Iterable[tuple[Any, str]] = ()) -> OpRecord:
    """Call ``fn(*args)``, whose tensors live on ``device``, under the
    recording mode and return its ``OpRecord`` (with ``counted``, the rise
    of the engine's sync count, and ``regions`` for each watched
    ``(module, function name)``)."""
    from repro_torch.net import torch_engine

    device = torch.device(device)
    record = OpRecord()
    recorder = _Recorder(record, device)
    before = torch_engine.sync_count()
    t0 = time.perf_counter()
    with _Watched(recorder, watch), recorder:
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    record.seconds = time.perf_counter() - t0
    record.counted = torch_engine.sync_count() - before
    return record


# ---------------------------------------------------------------------------
# Per-target dispatch checks
# ---------------------------------------------------------------------------


class _TargetFindings:
    """Deduplicated per-target findings: one finding per code, with an
    occurrence count."""

    def __init__(self, target: TraceTarget) -> None:
        self.target = target
        self._first: dict[str, str] = {}
        self._count: dict[str, int] = {}

    def add(self, code: str, message: str) -> None:
        self._first.setdefault(code, message)
        self._count[code] = self._count.get(code, 0) + 1

    def findings(self) -> list[Finding]:
        out = []
        for code, message in self._first.items():
            n = self._count[code]
            if n > 1:
                message = f"{message} (+{n - 1} more site(s))"
            out.append(Finding(
                checker=CHECKER, path=self.target.path, line=1,
                scope=self.target.scope, code=code, message=message,
            ))
        return out


def _check_record(found: _TargetFindings, label: str,
                  record: OpRecord) -> None:
    for (op, dtype), n in sorted(record.narrow.items()):
        found.add(
            "narrow-float-in-trace",
            f"case {label!r}: {op} outputs {dtype} ({n}x) on the pricing "
            "path — every priced quantity is float64",
        )
    seen = record.total_host_reads
    if seen != record.counted:
        found.add(
            "uncounted-host-sync",
            f"case {label!r}: the dispatch saw {seen} device→host read(s) "
            f"{dict(record.host_reads)!r} but torch_engine.sync_count() "
            f"rose by {record.counted} — count every read where it is "
            "made (or remove it)",
        )


def _trace_target(
    target: TraceTarget,
    budgets: dict[str, BudgetEntry],
    device: torch.device,
) -> tuple[list[Finding], list[OpRecord]]:
    found = _TargetFindings(target)
    max_ops = max_syncs = 0
    records = []
    for case in target.cases:
        record = None
        with _Caught(Exception) as caught:
            fn, args = case.make(device)
            record = trace(fn, args, device)
        if caught.error is not None:
            found.add(
                "trace-error",
                f"case {case.label!r} failed to build/run: "
                f"{caught.error!r} — the registry must stay runnable on "
                "every lint host",
            )
            continue
        records.append(record)
        _check_record(found, case.label, record)
        max_ops = max(max_ops, record.total_ops)
        max_syncs = max(max_syncs, record.total_host_reads)
    findings = found.findings()
    entry = budgets.get(target.name)
    if entry is None:
        findings.append(Finding(
            checker=CHECKER, path=MANIFEST_FILENAME, line=1,
            scope=target.name, code="missing-budget",
            message=(
                f"target {target.name!r} has no entry in "
                f"{MANIFEST_FILENAME} — record its budgets (measured "
                f"{max_ops} op(s), {max_syncs} device→host read(s); "
                "leave ~30% headroom)"
            ),
        ))
    else:
        for code, got, limit, what in (
                ("op-budget-exceeded", max_ops, entry.max_ops, "op(s)"),
                ("sync-budget-exceeded", max_syncs, entry.max_syncs,
                 "device→host read(s)")):
            if got > limit:
                findings.append(Finding(
                    checker=CHECKER, path=MANIFEST_FILENAME,
                    line=entry.line, scope=target.name, code=code,
                    message=(
                        f"target {target.name!r} dispatches {got} {what}, "
                        f"budget is {limit} — either a host round-trip or "
                        "an unrolling crept in (fix it) or the growth is "
                        "intentional (raise the budget in review)"
                    ),
                ))
    return findings, records


def check_targets(
    root: Path, device: str | torch.device = "cpu"
) -> tuple[list[Finding], dict[str, list[OpRecord]]]:
    """The dispatch pass alone: every registered target's cases run on
    ``device`` under the recording mode and held to the manifest. Returns
    the findings and each target's records."""
    device = torch.device(device)
    targets, findings = _load_targets(root)
    if not targets and not (root / MANIFEST_REL_PATH).is_file():
        # Tree registers no entry points (and budgets none).
        return findings, {}
    budgets, manifest_findings = load_manifest(root / MANIFEST_REL_PATH)
    findings.extend(manifest_findings)
    records: dict[str, list[OpRecord]] = {}
    for target in targets:
        got, records[target.name] = _trace_target(target, budgets, device)
        findings.extend(got)
    for name, entry in budgets.items():
        if name not in records:
            findings.append(Finding(
                checker=CHECKER, path=MANIFEST_FILENAME, line=entry.line,
                scope=name, code="stale-budget-entry",
                message=(
                    f"manifest budgets unknown target {name!r} — the "
                    "target was renamed or deleted; update the entry "
                    "(and make sure the certification moved with the "
                    "code)"
                ),
            ))
    return findings, records


# ---------------------------------------------------------------------------
# AST sync pass
# ---------------------------------------------------------------------------

_TENSOR = "tensor"
_SEQ = "seq"          # a list/tuple of tensors of unknown length
# torch.<name> calls that return no tensor.
_NOT_TENSOR_FNS = {
    "device", "dtype", "Generator", "is_tensor", "is_floating_point",
    "is_complex", "numel", "get_default_dtype", "Size", "finfo", "iinfo",
    "no_grad", "inference_mode", "enable_grad", "set_grad_enabled",
    "promote_types", "result_type", "can_cast", "manual_seed",
    "is_grad_enabled", "get_device",
}
_TORCH_SUBMODULES = {"nn.functional", "linalg", "special", "fft"}
_SEQ_FNS = {"split", "chunk", "unbind", "tensor_split", "meshgrid",
            "broadcast_tensors", "unflatten"}
# Tensor methods that return no tensor (host values or metadata).
_NOT_TENSOR_METHODS = {
    "item", "tolist", "numpy", "dim", "numel", "size", "stride",
    "data_ptr", "element_size", "nelement", "is_contiguous",
    "is_floating_point", "is_complex", "get_device", "storage_offset",
    "untyped_storage", "ndimension", "__len__",
}
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data", "grad"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"bool", "int", "float", "complex"}


def _join(a, b):
    if a is None or a == b:
        return b
    if b is None:
        return a
    return _TENSOR


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) == \
            "torch.device" and node.args:
        return _is_cpu(node.args[0])
    return False


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Every node in ``fn``'s body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _param_names(node: ast.AST) -> list[str]:
    a = node.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params


class _ModuleSyncScan:
    """One scanned module: the device closure, what in it holds tensors,
    and the ``implicit-host-sync`` findings."""

    def __init__(self, tree: ast.Module, path: str) -> None:
        self.path = path
        self.findings: list[Finding] = []
        self._flagged: set[int] = set()
        # def name -> (node, enclosing def name or None, dotted scope)
        self.defs: dict[str, tuple[ast.FunctionDef, str | None, str]] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._collect(node, None, node.name)
        self.params: dict[str, dict[str, Any]] = {
            name: {} for name in self.defs}
        self.returns: dict[str, Any] = {}
        self.envs: dict[str, dict[str, Any]] = {}

    def _collect(self, node, parent, scope) -> None:
        self.defs.setdefault(node.name, (node, parent, scope))
        for sub in _own_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._collect(sub, node.name, f"{scope}.{sub.name}")

    # -- the closure -------------------------------------------------------

    def closure(self) -> list[str]:
        seeds = [n for n in SYNC_SEEDS
                 if n in self.defs and self.defs[n][1] is None]
        seen, queue = set(seeds), list(seeds)
        while queue:
            name = queue.pop()
            for sub in _own_nodes(self.defs[name][0]):
                callee = None
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name):
                    callee = sub.func.id
                elif isinstance(sub, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    callee = sub.name
                if callee in self.defs and callee not in seen:
                    seen.add(callee)
                    queue.append(callee)
        return sorted(seen)

    # -- kinds -------------------------------------------------------------

    def kind(self, node: ast.AST, env: dict) -> Any:
        """``_TENSOR``, ``_SEQ``, a tuple of kinds, or None."""
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Call):
            return self._call_kind(node, env)
        if isinstance(node, ast.Attribute):
            if node.attr in _TENSOR_ATTRS and \
                    self.kind(node.value, env) == _TENSOR:
                return _TENSOR
            return None
        if isinstance(node, ast.BinOp):
            return _TENSOR if _TENSOR in (self.kind(node.left, env),
                                          self.kind(node.right, env)) \
                else None
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return None
            return self.kind(node.operand, env)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return None
            return _TENSOR if any(
                self.kind(e, env) == _TENSOR
                for e in [node.left, *node.comparators]) else None
        if isinstance(node, ast.BoolOp):
            out = None
            for v in node.values:
                out = _join(out, self.kind(v, env))
            return out
        if isinstance(node, ast.IfExp):
            return _join(self.kind(node.body, env),
                         self.kind(node.orelse, env))
        if isinstance(node, ast.Subscript):
            value = self.kind(node.value, env)
            if value == _TENSOR:
                return _TENSOR
            if value == _SEQ:
                return _SEQ if isinstance(node.slice, ast.Slice) \
                    else _TENSOR
            if isinstance(value, tuple) and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, int) and \
                    -len(value) <= node.slice.value < len(value):
                return value[node.slice.value]
            return None
        if isinstance(node, (ast.Tuple, ast.List)):
            kinds = tuple(self.kind(e, env) for e in node.elts)
            return kinds if any(k is not None for k in kinds) else None
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            inner = dict(env)
            for gen in node.generators:
                self._bind(gen.target, self._elem(gen.iter, inner), inner)
            return _SEQ if self.kind(node.elt, inner) == _TENSOR else None
        return None

    def _call_kind(self, node: ast.Call, env: dict) -> Any:
        func = node.func
        chain = dotted_name(func) or ""
        if chain.startswith("torch."):
            mod, _, leaf = chain[len("torch."):].rpartition(".")
            if mod and mod not in _TORCH_SUBMODULES:
                return None
            if leaf in _NOT_TENSOR_FNS:
                return None
            return _SEQ if leaf in _SEQ_FNS else _TENSOR
        if isinstance(func, ast.Attribute) and \
                self.kind(func.value, env) == _TENSOR:
            if func.attr in _NOT_TENSOR_METHODS:
                return None
            return _SEQ if func.attr in _SEQ_FNS else _TENSOR
        if isinstance(func, ast.Name):
            if func.id in self.defs:
                return self.returns.get(func.id)
            if func.id in ("list", "tuple") and len(node.args) == 1:
                return _SEQ if self._elem(node.args[0], env) == _TENSOR \
                    else None
            if func.id in ("abs", "max", "min", "sum"):
                return _TENSOR if any(
                    self.kind(a, env) in (_TENSOR, _SEQ)
                    for a in node.args) else None
        return None

    def _elem(self, node: ast.AST, env: dict) -> Any:
        """The kind of what iterating ``node`` yields."""
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "enumerate" and node.args:
                return (None, self._elem(node.args[0], env))
            if node.func.id == "zip":
                return tuple(self._elem(a, env) for a in node.args)
        got = self.kind(node, env)
        if got in (_TENSOR, _SEQ):
            return _TENSOR
        if isinstance(got, tuple):
            out = None
            for k in got:
                out = _join(out, k)
            return out
        return None

    def _bind(self, target: ast.AST, kind: Any, env: dict) -> bool:
        """Give ``target`` the kind; True when ``env`` changed."""
        if isinstance(target, ast.Name):
            new = _join(env.get(target.id), kind)
            if new != env.get(target.id):
                env[target.id] = new
                return True
            return False
        if isinstance(target, (ast.Tuple, ast.List)):
            changed = False
            for i, elt in enumerate(target.elts):
                if isinstance(kind, tuple):
                    sub = kind[i] if i < len(kind) else None
                else:
                    sub = _TENSOR if kind in (_TENSOR, _SEQ) else None
                changed |= self._bind(elt, sub, env)
            return changed
        return False

    def _env(self, name: str) -> dict:
        node, parent, _ = self.defs[name]
        env = dict(self.envs.get(parent, {})) if parent else {}
        env.update(self.params[name])
        for _ in range(8):
            changed = False
            for sub in _own_nodes(node):
                if isinstance(sub, ast.Assign):
                    value = self.kind(sub.value, env)
                    for t in sub.targets:
                        changed |= self._bind(t, value, env)
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)) \
                        and sub.value is not None:
                    value = self.kind(sub.value, env)
                    changed |= self._bind(sub.target, value, env)
                elif isinstance(sub, (ast.For, ast.comprehension)):
                    changed |= self._bind(
                        sub.target, self._elem(sub.iter, env), env)
            if not changed:
                break
        return env

    def infer(self, names: list[str]) -> None:
        """Fixpoint of parameter, local and return kinds over the
        closure (seeds take host values: the entry's arguments are the
        host arrays ``device_args`` builds)."""
        for _ in range(8):
            before = (repr(self.params), repr(self.returns))
            for name in names:
                env = self.envs[name] = self._env(name)
                node = self.defs[name][0]
                ret = None
                for sub in _own_nodes(node):
                    if isinstance(sub, ast.Return) and sub.value is not None:
                        ret = _join(ret, self.kind(sub.value, env))
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Name) and \
                            sub.func.id in names and \
                            sub.func.id not in SYNC_SEEDS:
                        self._pass_args(sub, env)
                self.returns[name] = ret
            if (repr(self.params), repr(self.returns)) == before:
                break

    def _pass_args(self, call: ast.Call, env: dict) -> None:
        callee = call.func.id
        params = _param_names(self.defs[callee][0])
        got = self.params[callee]
        for i, arg in enumerate(call.args):
            if i < len(params) and not isinstance(arg, ast.Starred):
                got[params[i]] = _join(got.get(params[i]),
                                       self.kind(arg, env))
        for kw in call.keywords:
            if kw.arg in params:
                got[kw.arg] = _join(got.get(kw.arg), self.kind(kw.value, env))

    # -- the findings ------------------------------------------------------

    def run(self) -> list[Finding]:
        names = self.closure()
        if not names:
            return self.findings
        self.infer(names)
        for name in names:
            node, _, scope = self.defs[name]
            self._block(node.body, self.envs[name], scope)
        return self.findings

    def _emit(self, node: ast.AST, scope: str, what: str) -> None:
        if id(node) in self._flagged:  # a test seen twice (``not``/``and``)
            return
        self._flagged.add(id(node))
        self.findings.append(Finding(
            checker=CHECKER, path=self.path,
            line=getattr(node, "lineno", 0), scope=scope,
            code="implicit-host-sync",
            message=(
                f"{what} reads a tensor back to the host inside the "
                "engine's device half — a synchronisation that "
                "torch_engine.sync_count() does not see; keep the value "
                "on the device, or count the read (``_syncs += 1`` just "
                "before it)"
            ),
        ))

    def _block(self, stmts: list[ast.stmt], env: dict, scope: str) -> None:
        for i, stmt in enumerate(stmts):
            counted = i > 0 and _counts_a_sync(stmts[i - 1])
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            exprs: list[ast.AST] = []
            if isinstance(stmt, (ast.If, ast.While)):
                if not counted:
                    self._test(stmt.test, env, scope,
                               type(stmt).__name__.lower())
                exprs.append(stmt.test)
                self._block(stmt.body, env, scope)
                self._block(stmt.orelse, env, scope)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                exprs.append(stmt.iter)
                self._block(stmt.body, env, scope)
                self._block(stmt.orelse, env, scope)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                exprs.extend(item.context_expr for item in stmt.items)
                self._block(stmt.body, env, scope)
            else:
                if isinstance(stmt, ast.Assert) and not counted:
                    self._test(stmt.test, env, scope, "assert")
                exprs.append(stmt)
            if not counted:
                for expr in exprs:
                    self._expr(expr, env, scope)

    def _test(self, test: ast.AST, env: dict, scope: str, what: str) -> None:
        """A truth test of ``test``: a tensor there is a host read."""
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                self._test(v, env, scope, what)
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            self._test(test.operand, env, scope, what)
        elif self.kind(test, env) == _TENSOR:
            self._emit(test, scope, f"an {what} on a tensor")

    def _expr(self, root: ast.AST, env: dict, scope: str) -> None:
        for node in ast.walk(root):
            if isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) and \
                        self.kind(func.value, env) == _TENSOR:
                    if func.attr in _HOST_METHODS:
                        self._emit(node, scope, f".{func.attr}()")
                    elif func.attr == "to" and (
                            (node.args and _is_cpu(node.args[0])) or any(
                                kw.arg == "device" and _is_cpu(kw.value)
                                for kw in node.keywords)):
                        self._emit(node, scope, '.to("cpu")')
                elif isinstance(func, ast.Name) and \
                        func.id in _HOST_CASTS and node.args and \
                        self.kind(node.args[0], env) == _TENSOR:
                    self._emit(node, scope, f"{func.id}() of a tensor")
            elif isinstance(node, ast.IfExp):
                self._test(node.test, env, scope, "conditional expression")
            elif isinstance(node, ast.UnaryOp) and \
                    isinstance(node.op, ast.Not):
                self._test(node.operand, env, scope, "not")
            elif isinstance(node, ast.BoolOp):
                for v in node.values[:-1]:
                    self._test(v, env, scope, "and/or")
            elif isinstance(node, ast.comprehension):
                for cond in node.ifs:
                    self._test(cond, env, scope, "comprehension filter")


def _counts_a_sync(stmt: ast.stmt) -> bool:
    """``<counter> += 1`` for one of ``SYNC_COUNTERS``."""
    return isinstance(stmt, ast.AugAssign) and \
        isinstance(stmt.op, ast.Add) and \
        isinstance(stmt.target, ast.Name) and \
        stmt.target.id in SYNC_COUNTERS and \
        isinstance(stmt.value, ast.Constant) and stmt.value.value == 1


def _sync_ast_pass(root: Path) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_python_files(root, SYNC_SCAN_DIRS):
        tree = parse_file(path)
        if tree is None:
            continue
        findings.extend(_ModuleSyncScan(tree, rel(path, root)).run())
    return findings


# ---------------------------------------------------------------------------
# Metrics (tests and the chip run; not part of check())
# ---------------------------------------------------------------------------


def waterfill_metrics(record: OpRecord, rounds: int) -> dict[str, float]:
    """Per water-fill round, what ``_waterfill`` dispatched (its set-up
    before the first round included, spread over its rounds): aten ops,
    device→host reads and the bytes of the ops' outputs — what a fused
    water-filling kernel would take away."""
    ops, reads, nbytes = record.regions.get("_waterfill", (0, 0, 0))
    if not rounds:
        return {}
    return {
        "waterfill_rounds": rounds,
        "waterfill_ops_per_round": ops / rounds,
        "waterfill_host_reads_per_round": reads / rounds,
        "waterfill_output_bytes_per_round": nbytes / rounds,
    }


def trace_rounds(fn: Callable, args: tuple,
                 device: str | torch.device = "cpu") -> tuple[OpRecord, dict]:
    """``trace`` with ``_waterfill`` watched, and its per-round metrics."""
    from repro_torch.net import torch_engine

    rounds = torch_engine.round_count()
    record = trace(fn, args, device, watch=((torch_engine, "_waterfill"),))
    return record, waterfill_metrics(
        record, torch_engine.round_count() - rounds)


def collect_metrics(root: Path | None = None,
                    device: str | torch.device = "cpu") -> dict[str, float]:
    """Per-target aten ops and device→host reads, plus the water-fill
    numbers of ``rollout-batch``, at each target's *first* (canonical)
    case on ``device``."""
    root = (root or repo_root()).resolve()
    targets, findings = _load_targets(root)
    if findings:
        raise RuntimeError(findings[0].message)
    device = torch.device(device)
    metrics: dict[str, float] = {}
    for target in targets:
        fn, args = target.cases[0].make(device)
        key = target.name.replace("-", "_")
        if target.name == "rollout-batch":
            record, per_round = trace_rounds(fn, args, device)
            metrics.update(per_round)
        else:
            record = trace(fn, args, device)
        metrics[f"ops_{key}"] = record.total_ops
        metrics[f"host_reads_{key}"] = record.total_host_reads
    return metrics


# ---------------------------------------------------------------------------
# Checker entry
# ---------------------------------------------------------------------------


def check(root: Path) -> list[Finding]:
    """The AST sync pass, then the dispatch pass on the CPU (the lint runs
    on any host; ``chip_smoke.py`` runs ``check_targets`` on the card)."""
    findings = _sync_ast_pass(root)
    findings.extend(check_targets(root, "cpu")[0])
    return findings
