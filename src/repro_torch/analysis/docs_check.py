"""Docs gate — the port's module map must stay complete.

The port's own copy of the JAX package's ``analysis/docs_check.py``.
``docs/architecture_torch.md`` is the port's entry point, in the shape of
the reference's ``docs/architecture.md``: it lists every public module of
the port's four library packages (``net/``, ``core/``, ``runtime/``,
``analysis/``) with a one-line purpose and its counterpart in the JAX
package.

Docs that describe a subset of the tree rot silently — a new module
that nobody linked is a module nobody finds. This checker makes the
listing a lint invariant, as the reference's gate does for its own map:

* ``missing-architecture-doc`` — the tree has library packages but no
  ``docs/architecture_torch.md`` at all;
* ``undocumented-module`` — a public module (any ``*.py`` whose name
  does not start with ``_``) under a checked package is never
  mentioned by filename in the doc.

The check is textual on purpose: mentioning ``foo.py`` anywhere in the
doc satisfies it, so prose, tables, and code spans all count. Waivers
(``waivers.txt``) cover intentionally undocumented modules.
"""

from __future__ import annotations

from pathlib import Path

from repro_torch.analysis.common import Finding, iter_python_files, rel

DOC_REL_PATH = "docs/architecture_torch.md"

CHECK_DIRS = [
    "src/repro_torch/net",
    "src/repro_torch/core",
    "src/repro_torch/runtime",
    "src/repro_torch/analysis",
]


def public_modules(root: Path) -> list[Path]:
    """Library modules the doc must list: every ``*.py`` under the
    checked packages except private/dunder ones (``_*``)."""
    return [
        p for p in iter_python_files(root, CHECK_DIRS)
        if not p.name.startswith("_")
    ]


def check(root: Path) -> list[Finding]:
    modules = public_modules(root)
    if not modules:
        return []
    doc = root / DOC_REL_PATH
    if not doc.is_file():
        return [Finding(
            checker="docs", path=DOC_REL_PATH, line=1, scope="<module>",
            code="missing-architecture-doc",
            message=(
                f"{DOC_REL_PATH} not found but the tree has "
                f"{len(modules)} public library module(s) — the module "
                "map is the port's gated entry point (the counterpart "
                "of docs/architecture.md)"
            ),
        )]
    text = doc.read_text()
    findings: list[Finding] = []
    for mod in modules:
        if mod.name not in text:
            findings.append(Finding(
                checker="docs", path=rel(mod, root), line=1,
                scope="<module>", code="undocumented-module",
                message=(
                    f"{mod.name} is not mentioned in {DOC_REL_PATH}; "
                    "add it to the module map (one line: what it is) "
                    "or waive it with a reason"
                ),
            ))
    return findings
