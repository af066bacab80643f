"""Run one cell of BENCHMARK.json once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The program under test is ``src/repro_torch``
of that checkout; its kernels build into the checkout's ``build/``."""

import time

T0 = time.perf_counter()   # the set-up's clock starts before any import

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# the package's own directory off the path: its module names are its own
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
