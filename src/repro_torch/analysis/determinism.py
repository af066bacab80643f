"""Determinism lint.

The port's own copy of the JAX package's ``analysis/determinism.py``,
over ``src/repro_torch/{net,core,runtime}``.

Every priced makespan, routed tree, and sampled realization in this
repo is contractually reproducible from explicit seeds (same seed ⇒
bitwise-identical output — the property the parity tests lean on).
This checker flags the statically detectable ways that contract
breaks inside ``net/``, ``core/``, and ``runtime/``:

``global-numpy-rng``         ``np.random.<fn>()`` — the legacy global
                             generator; use ``np.random.default_rng(seed)``.
``unseeded-default-rng``     ``np.random.default_rng()`` with no arguments
                             (OS-entropy seeded) — thread the caller's seed.
``stdlib-random``            module-level ``random.<fn>()`` — global,
                             hash-seeded state.
``unseeded-random-ctor``     ``random.Random()`` / ``np.random.Generator``
                             family constructed without a seed.
``impure-prng-seed``         a PRNG seed built from a time/os/uuid call
                             (``np.random.default_rng(time.time_ns())``,
                             ``gen.manual_seed(os.getpid())`` and kin).
``global-torch-rng``         torch's process-global generator: any
                             ``torch.manual_seed``/``torch.seed``, and
                             ``torch.rand``/``randn``/``randint``/
                             ``randperm``/``bernoulli``/``multinomial``/
                             ``normal`` (and their ``*_like`` forms and
                             the in-place ``Tensor.normal_``/``uniform_``/
                             ``random_``/``bernoulli_``/``exponential_``)
                             without ``generator=`` — draws depend on
                             every draw made before them in the process.
``unseeded-torch-generator`` ``torch.Generator(...)`` that is not seeded
                             where it is made (``torch.Generator(device=
                             d).manual_seed(seed)`` is the seeded form):
                             a fresh generator's default seed is a
                             constant shared by every such site, or,
                             after ``Generator.seed()``, OS entropy.
``time-read``                wall/monotonic clock reads — fine for
                             telemetry fields, poison for anything that
                             feeds results; telemetry sites get waivers.
``env-read``                 ``os.environ``/``os.getenv`` — behavior must
                             come from arguments, not ambient environment.
``os-entropy``               ``os.urandom``/``uuid.uuid4`` and friends.
``set-iteration-order``      iterating a set/frozenset expression directly
                             (``for x in set(...)``, ``list({...})``) —
                             hash-order-dependent; sort first. ``sorted()``
                             over a set is explicitly fine.

The reference's ``fresh-prng-key`` (a ``jax.random.PRNGKey`` minted from
literals) has no counterpart: the port holds no JAX keys, and a torch
generator seeded from a literal is a seeded generator like any other.
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

CHECKER = "determinism"

SCAN_DIRS = [
    "src/repro_torch/net", "src/repro_torch/core", "src/repro_torch/runtime",
]

_STDLIB_RANDOM_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "seed", "getrandbits", "randbytes",
}
_TIME_READS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today", "datetime.now", "datetime.utcnow",
    "date.today",
}
_OS_ENTROPY = {"os.urandom", "uuid.uuid1", "uuid.uuid4", "secrets.token_bytes",
               "secrets.token_hex", "secrets.randbelow"}
_ENV_READS = {"os.getenv", "os.environb"}
_PRNG_CTORS = {
    # dotted-suffix -> needs an explicit seed argument
    "random.default_rng", "random.Random", "random.SeedSequence",
}
# torch's sampling functions that draw from the global generator unless
# handed ``generator=``.
_TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
_TORCH_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
}
# In-place Tensor samplers; the same draw from the global generator.
_TENSOR_SAMPLERS = {
    "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}


def _is_np_random(chain: str) -> bool:
    """``np.random.X`` / ``numpy.random.X`` (module attribute access,
    not a method on some generator object)."""
    parts = chain.split(".")
    return len(parts) == 3 and parts[0] in ("np", "numpy") and \
        parts[1] == "random"


def _contains_impure_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = dotted_name(sub.func)
            if chain and (chain in _TIME_READS or chain in _OS_ENTROPY
                          or chain in _ENV_READS
                          or chain.startswith("os.environ")):
                return True
    return False


def _is_set_expr(node: ast.AST) -> bool:
    """An expression whose value is a set with hash-dependent order."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


class _Visitor(ScopedVisitor):
    def __init__(self, path: str) -> None:
        super().__init__()
        self.path = path
        self.findings: list[Finding] = []
        # ``torch.Generator(...)`` calls seeded where they are made (the
        # receiver of a ``.manual_seed(...)`` call), by node identity.
        self._seeded: set[int] = set()

    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        self.findings.append(Finding(
            checker=CHECKER, path=self.path,
            line=getattr(node, "lineno", 0), scope=self.scope,
            code=code, message=message,
        ))

    def visit_Call(self, node: ast.Call) -> None:
        chain = dotted_name(node.func)
        if chain:
            self._check_call(node, chain)
        if isinstance(node.func, ast.Attribute):
            self._check_method(node, node.func)
        # list(set(...)) / tuple(set(...)) materialize hash order;
        # sorted(set(...)) canonicalizes it and is explicitly fine.
        if (
            isinstance(node.func, ast.Name)
            and node.func.id in ("list", "tuple")
            and len(node.args) == 1
            and _is_set_expr(node.args[0])
        ):
            self._emit(
                node, "set-iteration-order",
                f"{node.func.id}() over a set expression materializes "
                "hash-dependent order — use sorted(...) instead",
            )
        self.generic_visit(node)

    def _check_method(self, node: ast.Call, func: ast.Attribute) -> None:
        """Calls on an object: ``<gen>.manual_seed(...)`` and the
        in-place Tensor samplers."""
        if func.attr == "manual_seed":
            receiver = func.value
            if isinstance(receiver, ast.Call) and \
                    dotted_name(receiver.func) == "torch.Generator":
                self._seeded.add(id(receiver))
            if (
                any(_contains_impure_call(a) for a in node.args)
                or any(_contains_impure_call(kw.value)
                       for kw in node.keywords)
            ):
                self._emit(
                    node, "impure-prng-seed",
                    "manual_seed(...) seeded from a time/os/uuid read — "
                    "seeds must be explicit, reproducible values",
                )
        elif func.attr in _TENSOR_SAMPLERS and not _has_generator(node):
            self._emit(
                node, "global-torch-rng",
                f".{func.attr}() without generator= draws from torch's "
                "process-global generator — pass a seeded "
                "torch.Generator",
            )

    def _check_call(self, node: ast.Call, chain: str) -> None:
        leaf = chain.rsplit(".", 1)[-1]
        if _is_np_random(chain):
            if leaf == "default_rng":
                if not node.args and not node.keywords:
                    self._emit(
                        node, "unseeded-default-rng",
                        "np.random.default_rng() with no seed draws OS "
                        "entropy — thread an explicit seed through",
                    )
                elif any(_contains_impure_call(a) for a in node.args):
                    self._emit(
                        node, "impure-prng-seed",
                        "np.random.default_rng(<time/os read>) — seeds "
                        "must be explicit values, not ambient state",
                    )
            elif leaf in ("Generator", "SeedSequence", "Philox", "PCG64"):
                if not node.args and not node.keywords:
                    self._emit(
                        node, "unseeded-random-ctor",
                        f"np.random.{leaf}() without a seed draws OS "
                        "entropy — pass the caller's seed",
                    )
            else:
                self._emit(
                    node, "global-numpy-rng",
                    f"np.random.{leaf}() uses the process-global legacy "
                    "generator (shared, import-order-dependent state) — "
                    "use np.random.default_rng(seed)",
                )
        elif chain.startswith("random.") and leaf in _STDLIB_RANDOM_FNS \
                and chain.count(".") == 1:
            self._emit(
                node, "stdlib-random",
                f"random.{leaf}() uses the global stdlib generator — "
                "use a seeded np.random.default_rng(seed)",
            )
        elif chain == "random.Random" and not node.args \
                and not node.keywords:
            self._emit(
                node, "unseeded-random-ctor",
                "random.Random() without a seed — pass the caller's seed",
            )
        elif chain in _TORCH_GLOBAL_SEEDS:
            self._emit(
                node, "global-torch-rng",
                f"{chain}() seeds torch's process-global generator — "
                "every later global draw anywhere in the process depends "
                "on it; make a torch.Generator and seed that",
            )
        elif chain.startswith("torch.") and chain.count(".") == 1 \
                and leaf in _TORCH_SAMPLERS and not _has_generator(node):
            self._emit(
                node, "global-torch-rng",
                f"{chain}() without generator= draws from torch's "
                "process-global generator — pass a seeded "
                "torch.Generator",
            )
        elif chain == "torch.Generator" and id(node) not in self._seeded:
            self._emit(
                node, "unseeded-torch-generator",
                "torch.Generator(...) not seeded where it is made — "
                "write torch.Generator(device=d).manual_seed(seed) with "
                "the caller's seed",
            )
        elif chain in _TIME_READS:
            self._emit(
                node, "time-read",
                f"{chain}() reads the clock — results must not depend "
                "on wall time (telemetry-only sites need a waiver "
                "naming the field they feed)",
            )
        elif chain in _OS_ENTROPY:
            self._emit(
                node, "os-entropy",
                f"{chain}() draws OS entropy — derive randomness from "
                "an explicit seed",
            )
        elif chain in _ENV_READS:
            self._emit(
                node, "env-read",
                f"{chain}() reads the environment — behavior must come "
                "from arguments, not ambient state",
            )
        if any(chain.endswith(suffix) for suffix in _PRNG_CTORS) and (
            any(_contains_impure_call(a) for a in node.args)
            or any(_contains_impure_call(kw.value) for kw in node.keywords)
        ):
            self._emit(
                node, "impure-prng-seed",
                f"{chain}(...) seeded from a time/os/uuid read — seeds "
                "must be explicit, reproducible values",
            )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if dotted_name(node) == "os.environ":
            self._emit(
                node, "env-read",
                "os.environ read — behavior must come from arguments, "
                "not ambient environment",
            )
        self.generic_visit(node)

    def _check_iter(self, iter_node: ast.AST) -> None:
        if _is_set_expr(iter_node):
            self._emit(
                iter_node, "set-iteration-order",
                "iterating a set expression directly — iteration order "
                "is hash-dependent; sort (or otherwise canonicalize) "
                "before iterating",
            )

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


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
