"""Parity-coverage checker.

The port's own copy of the JAX package's ``analysis/parity.py`` (same
manifest grammar, same codes), over ``src/repro_torch``: each of the
port's ``*_reference`` implementations is registered with its fast path
and the ``tests/test_torch_*.py`` file that exercises both.

Every speedup PR in this repo follows the same pattern: keep the
original implementation as ``*_reference`` ground truth and
property-test the fast path bitwise (or rtol) against it. That
discipline is only worth anything if the tests *stay* registered — an
optimization PR that deletes or forgets the parity test silently
removes the one thing standing between "fast" and "fast but wrong".

This checker makes the pairing explicit. ``parity_manifest.txt``
(next to this module; per-tree) registers every reference
implementation::

    <src-file>::<reference-def>  <fast-symbol>  <test-file>[,<test>…]  [via=<token>]

and the checker fails when:

``unregistered-reference``   a ``*_reference`` def exists in the port
                             with no manifest entry;
``stale-manifest-entry``     a manifest entry names a file or def that
                             no longer exists;
``missing-parity-test``      a registered test file does not exist;
``parity-test-lacks-symbol`` the test file's AST mentions neither the
                             reference def (nor its ``via=`` token —
                             e.g. the simulator reference engine is
                             reached as ``engine="reference"``) nor
                             the fast symbol;
``malformed-manifest``       a line that doesn't parse.

Mentions are AST-level: an identifier (Name/Attribute/import) or an
exact string constant — a docstring that merely *talks about* the
symbol doesn't count, ``engine="reference"`` does.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from repro_torch.analysis.common import Finding, dotted_name, parse_file, rel

CHECKER = "parity"

MANIFEST_FILENAME = "parity_manifest.txt"
SRC_SCAN_DIR = "src/repro_torch"


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    src_file: str       # repo-relative, POSIX
    reference: str      # def name
    fast: str           # fast-path symbol the tests must also touch
    tests: tuple[str, ...]
    via: str | None     # alternate mention token (string constant)
    line: int           # in the manifest file


def load_manifest(path: Path) -> tuple[list[ManifestEntry], list[Finding]]:
    entries: list[ManifestEntry] = []
    findings: list[Finding] = []
    if not path.is_file():
        return entries, findings
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        fields = line.split()
        via = None
        if fields and fields[-1].startswith("via="):
            via = fields.pop()[len("via="):]
        if len(fields) != 3 or "::" not in fields[0]:
            findings.append(Finding(
                checker=CHECKER, path=path.name, line=lineno,
                scope="<module>", code="malformed-manifest",
                message=(
                    f"cannot parse {raw!r}: expected "
                    "'src_file::reference fast test[,test...] "
                    "[via=token]'"
                ),
            ))
            continue
        src_file, _, reference = fields[0].partition("::")
        entries.append(ManifestEntry(
            src_file=src_file, reference=reference, fast=fields[1],
            tests=tuple(fields[2].split(",")), via=via, line=lineno,
        ))
    return entries, findings


def _reference_defs(root: Path) -> dict[tuple[str, str], int]:
    """(repo-relative file, def name) -> line, for every function whose
    name ends in ``_reference`` under ``src/repro_torch``."""
    out: dict[tuple[str, str], int] = {}
    src = root / SRC_SCAN_DIR
    if not src.is_dir():
        return out
    for path in sorted(src.rglob("*.py")):
        tree = parse_file(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name.endswith("_reference"):
                out[(rel(path, root), node.name)] = node.lineno
    return out


def _mentions(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(identifier mentions, exact string constants) in a test AST."""
    names: set[str] = set()
    strings: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
            chain = dotted_name(node)
            if chain:
                names.add(chain)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.add(node.value)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add(alias.name.rsplit(".", 1)[-1])
                if alias.asname:
                    names.add(alias.asname)
    return names, strings


def check(root: Path) -> list[Finding]:
    manifest_path = root / "src/repro_torch/analysis" / MANIFEST_FILENAME
    entries, findings = load_manifest(manifest_path)
    defs = _reference_defs(root)
    registered = {(e.src_file, e.reference) for e in entries}

    for (src_file, name), lineno in sorted(defs.items()):
        if (src_file, name) not in registered:
            findings.append(Finding(
                checker=CHECKER, path=src_file, line=lineno,
                scope=name, code="unregistered-reference",
                message=(
                    f"reference implementation {name!r} has no entry in "
                    f"{MANIFEST_FILENAME} — register its fast path and "
                    "parity test so coverage cannot be dropped silently"
                ),
            ))

    for e in entries:
        if (e.src_file, e.reference) not in defs:
            findings.append(Finding(
                checker=CHECKER, path=manifest_path.name, line=e.line,
                scope=e.reference, code="stale-manifest-entry",
                message=(
                    f"{e.src_file}::{e.reference} no longer exists — "
                    "update or remove the manifest entry (and make sure "
                    "the parity guarantee moved with the code)"
                ),
            ))
            continue
        for test_rel in e.tests:
            test_path = root / test_rel
            if not test_path.is_file():
                findings.append(Finding(
                    checker=CHECKER, path=test_rel, line=0,
                    scope=e.reference, code="missing-parity-test",
                    message=(
                        f"registered parity test file for {e.reference} "
                        "does not exist"
                    ),
                ))
                continue
            tree = parse_file(test_path)
            if tree is None:
                continue
            names, strings = _mentions(tree)
            ref_hit = e.reference in names or (
                e.via is not None and e.via in strings
            )
            fast_hit = e.fast in names or e.fast in strings
            if not (ref_hit and fast_hit):
                missing = e.reference if not ref_hit else e.fast
                findings.append(Finding(
                    checker=CHECKER, path=test_rel, line=1,
                    scope=e.reference, code="parity-test-lacks-symbol",
                    message=(
                        f"test file never references {missing!r} — the "
                        "registered parity test must exercise both the "
                        "reference and the fast path"
                    ),
                ))
    return findings
