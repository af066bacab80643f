"""Shared machinery for the port's static checkers.

The port's own copy of the JAX package's ``analysis/common.py``; given
the same inputs, it returns what the reference returns.

A *finding* is one violation at one site. Its waiver key is
``checker path scope code`` — function-scoped rather than
line-numbered so waivers survive unrelated edits to the file, but
specific enough that a new violation of the same kind in a *different*
function is never silently covered by an old exemption.

``waivers.txt`` (next to this module; per-tree, so fixture trees carry
their own or none) holds one reviewed exemption per line::

    checker  path  scope  code  -- reason the invariant is safe here

Malformed lines (no ``--`` reason) and waivers that no finding used
are themselves findings: the file must stay an exact, reviewed list of
live exemptions — fixing a violation *removes* its entry.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

WAIVERS_FILENAME = "waivers.txt"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation at one site."""

    checker: str   # determinism | dtypes | parity | contracts | waivers
    path: str      # repo-root-relative, POSIX separators
    line: int
    scope: str     # dotted enclosing def/class qualname, or <module>
    code: str      # stable machine-readable violation kind
    message: str

    @property
    def waiver_key(self) -> str:
        return f"{self.checker} {self.path} {self.scope} {self.code}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.checker}/{self.code}] "
            f"{self.scope}: {self.message}"
        )


def repo_root() -> Path:
    """The tree this installed package belongs to
    (``src/repro_torch/analysis/common.py`` -> three parents up)."""
    return Path(__file__).resolve().parents[3]


def rel(path: Path, root: Path) -> str:
    return path.resolve().relative_to(root.resolve()).as_posix()


def iter_python_files(root: Path, rel_dirs: list[str]) -> list[Path]:
    """All ``.py`` files under ``root/<d>`` for each relative dir (a
    single file path is accepted too), sorted for stable output."""
    out: list[Path] = []
    for d in rel_dirs:
        p = root / d
        if p.is_file():
            out.append(p)
        elif p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
    return out


class _Caught:
    """``with _Caught(T) as c:`` runs its block and, if it raises an
    exception of a type in ``T``, stops there and keeps it in ``c.error``
    (None otherwise) — the reference's ``except T`` clause. Any other
    exception propagates."""

    def __init__(self, *types: type[BaseException]):
        self.types = types
        self.error: BaseException | None = None

    def __enter__(self) -> "_Caught":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and issubclass(exc_type, self.types):
            self.error = exc
            return True
        return False


def parse_file(path: Path) -> ast.AST | None:
    """AST of ``path``; None (skip, not crash) on syntax errors — the
    tier-1 suite, not the linter, owns 'does it parse'."""
    tree = None
    with _Caught(SyntaxError):
        tree = ast.parse(path.read_text(), filename=str(path))
    return tree


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the dotted def/class scope of each node.

    Subclasses read ``self.scope`` inside ``visit_*`` methods.
    """

    def __init__(self) -> None:
        self._stack: list[str] = []

    @property
    def scope(self) -> str:
        return ".".join(self._stack) if self._stack else "<module>"

    def _scoped(self, node) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_ClassDef = _scoped


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# Waivers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Waiver:
    key: str      # "checker path scope code"
    reason: str
    line: int     # in the waiver file


def load_waivers(path: Path) -> tuple[list[Waiver], list[Finding]]:
    """Parse the waiver file; malformed lines come back as findings."""
    waivers: list[Waiver] = []
    findings: list[Finding] = []
    if not path.is_file():
        return waivers, findings
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        head, sep, reason = line.partition("--")
        fields = head.split()
        if len(fields) != 4 or not sep or not reason.strip():
            findings.append(Finding(
                checker="waivers", path=path.name, line=lineno,
                scope="<module>", code="malformed-waiver",
                message=(
                    f"cannot parse {raw!r}: expected 'checker path "
                    "scope code -- reason' (the reason is mandatory — "
                    "every exemption is a reviewed decision)"
                ),
            ))
            continue
        waivers.append(
            Waiver(key=" ".join(fields), reason=reason.strip(), line=lineno)
        )
    return waivers, findings


def apply_waivers(
    findings: list[Finding], waivers: list[Waiver], waiver_path: Path
) -> tuple[list[Finding], list[Finding]]:
    """Split into (unwaived, waived); unused waivers become new
    unwaived findings so stale exemptions cannot linger."""
    by_key = {w.key: w for w in waivers}
    used: set[str] = set()
    unwaived: list[Finding] = []
    waived: list[Finding] = []
    for f in findings:
        if f.waiver_key in by_key:
            used.add(f.waiver_key)
            waived.append(f)
        else:
            unwaived.append(f)
    for w in waivers:
        if w.key not in used:
            unwaived.append(Finding(
                checker="waivers", path=waiver_path.name, line=w.line,
                scope="<module>", code="unused-waiver",
                message=(
                    f"waiver {w.key!r} matched no finding — the "
                    "violation was fixed or moved; delete the entry "
                    "(waivers must list live exemptions only)"
                ),
            ))
    return unwaived, waived
