"""Static contract-wiring checker.

The port's own copy of the JAX package's ``analysis/contracts_static.py``,
over ``src/repro_torch`` against the port's own ``contracts.VALIDATORS``
(the reference's three CSR structures plus the torch engine's padded
``DeviceIncidence``).

The runtime contracts (``repro_torch.analysis.contracts``) only protect the
CSR structures if the structures actually call into them: each class
registered in ``contracts.VALIDATORS`` must define a ``__post_init__``
whose body calls ``maybe_validate(self)``. This checker verifies that
wiring statically, so a refactor that rebuilds one of the dataclasses
(or adds a new constructor path via ``dataclasses.replace`` — which
re-runs ``__post_init__`` — but drops the hook) fails CI rather than
silently shipping an unvalidated structure.

``missing-contract-hook``  a registered class is defined without the
                           ``__post_init__`` → ``maybe_validate`` hook;
``contract-class-missing`` a registered class is not defined anywhere
                           under ``src/repro_torch`` — renaming a structure
                           must carry its contract along.
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.common import Finding, dotted_name, parse_file, rel
from repro_torch.analysis.contracts import VALIDATORS

CHECKER = "contracts"

SRC_SCAN_DIR = "src/repro_torch"
HOOK_NAME = "maybe_validate"


def _has_hook(cls: ast.ClassDef) -> bool:
    for item in cls.body:
        if isinstance(item, ast.FunctionDef) and \
                item.name == "__post_init__":
            for node in ast.walk(item):
                if isinstance(node, ast.Call):
                    chain = dotted_name(node.func) or ""
                    if chain.rsplit(".", 1)[-1] == HOOK_NAME:
                        return True
    return False


def check(root: Path) -> list[Finding]:
    findings: list[Finding] = []
    found: set[str] = set()
    src = root / SRC_SCAN_DIR
    files = sorted(src.rglob("*.py")) if src.is_dir() else []
    for path in files:
        if "analysis" in path.parts:
            continue  # the contract layer itself defines no structures
        tree = parse_file(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name in VALIDATORS:
                found.add(node.name)
                if not _has_hook(node):
                    findings.append(Finding(
                        checker=CHECKER, path=rel(path, root),
                        line=node.lineno, scope=node.name,
                        code="missing-contract-hook",
                        message=(
                            f"{node.name} has a registered runtime "
                            "contract but no __post_init__ calling "
                            f"{HOOK_NAME}(self) — constructions would "
                            "skip validation even under REPRO_VALIDATE=1"
                        ),
                    ))
    for name in sorted(set(VALIDATORS) - found):
        findings.append(Finding(
            checker=CHECKER, path=SRC_SCAN_DIR, line=0,
            scope=name, code="contract-class-missing",
            message=(
                f"no class named {name} found under {SRC_SCAN_DIR} but "
                "contracts.VALIDATORS registers one — if the structure "
                "was renamed, move its validator (and hook) with it"
            ),
        ))
    return findings
