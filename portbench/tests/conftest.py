"""The benchmark's CPU tests: ``python -m pytest portbench/tests`` from the
repository's root. The program is ``src/repro_torch``."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
