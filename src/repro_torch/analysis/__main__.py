"""CLI: ``python -m repro_torch.analysis [--all | --<checker>... | name...]``.

The port's counterpart of ``python -m repro.analysis``: runs the port's
static invariant checkers over ``src/repro_torch`` and exits non-zero
when any unwaived finding remains (2 on usage errors such as an unknown
checker name). ``--root`` points the suite at another tree (the negative
fixtures under ``tests/fixtures/lint_negative_torch`` are the self-test:
at least one planted violation per code).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch.analysis import (
    common,
    contracts_static,
    determinism,
    docs_check,
    dtypes,
    parity,
    tracelint,
)

CHECKERS = {
    "determinism": determinism.check,
    "dtypes": dtypes.check,
    "parity": parity.check,
    "contracts": contracts_static.check,
    "docs": docs_check.check,
    "tracelint": tracelint.check,
}


def run(
    root: Path, names: list[str], waiver_path: Path | None = None
) -> tuple[list[common.Finding], list[common.Finding]]:
    """(unwaived, waived) findings of the selected checkers on
    ``root``. The waiver file defaults to the tree's own
    ``src/repro_torch/analysis/waivers.txt`` (fixture trees ship their
    own or none)."""
    findings: list[common.Finding] = []
    for name in names:
        findings.extend(CHECKERS[name](root))
    if waiver_path is None:
        waiver_path = root / "src/repro_torch/analysis" / \
            common.WAIVERS_FILENAME
    waivers, waiver_findings = common.load_waivers(waiver_path)
    findings.extend(waiver_findings)
    return common.apply_waivers(findings, waivers, waiver_path)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--all", action="store_true",
                    help="run every checker (default when none selected)")
    for name in CHECKERS:
        ap.add_argument(f"--{name}", action="store_true",
                        help=f"run the {name} checker")
    ap.add_argument("--root", type=Path, default=None,
                    help="tree to analyze (default: this repo)")
    ap.add_argument("--waivers", type=Path, default=None,
                    help="waiver file (default: <root>/src/repro_torch/"
                         "analysis/waivers.txt)")
    ap.add_argument("checkers", nargs="*", metavar="checker",
                    help="checker names to run (same as the --<name> "
                         "flags; unknown names exit 2)")
    args = ap.parse_args(argv)

    unknown = [n for n in args.checkers if n not in CHECKERS]
    if unknown:
        print(
            f"repro_torch.analysis: unknown checker(s) "
            f"{', '.join(repr(n) for n in unknown)} — valid names: "
            f"{', '.join(CHECKERS)}",
            file=sys.stderr,
        )
        return 2
    selected = [
        n for n in CHECKERS if getattr(args, n) or n in args.checkers
    ]
    if args.all or not selected:
        selected = list(CHECKERS)
    root = (args.root or common.repo_root()).resolve()

    t0 = time.perf_counter()
    unwaived, waived = run(root, selected, args.waivers)
    elapsed = time.perf_counter() - t0

    for f in sorted(unwaived, key=lambda f: (f.path, f.line)):
        print(f.render())
    print(
        f"repro_torch.analysis: {', '.join(selected)} on {root} — "
        f"{len(unwaived)} finding(s), {len(waived)} waived, "
        f"{elapsed:.2f}s"
    )
    return 1 if unwaived else 0


if __name__ == "__main__":
    sys.exit(main())
