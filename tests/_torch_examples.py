"""One example of the JAX package and its port's counterpart, run in one
process (tests/test_torch_examples.py starts these processes all at once):

    python tests/_torch_examples.py MODE NAME OUT [ARG ...]

runs ``examples/NAME.py``'s ``main()`` with the ARGs, then
``examples/NAME_torch.py``'s ``main()`` with the same ARGs and
``--device cpu``. MODE ``user`` runs both as a user runs them (the JAX
package with x64 off); MODE ``replay`` turns x64 on (as every port test
does: the reference's float32 Adam steers SCA through quantities the port
computes in float64) and records every ``optimize_weights`` call of the
JAX designer (``_torch_design.RecordedOptimiser``), then replays those
results to the port's designer call by call. Writes to OUT, as JSON, both
stdouts, the two lists of optimiser calls and the status of every MILP
either side solved (0: optimal; 1: stopped by its time limit)."""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import pytest  # noqa: E402
import torch  # noqa: E402

from _torch_design import RecordedOptimiser  # noqa: E402
from repro import compat as jcompat  # noqa: E402
from repro.net import routing as jrouting  # noqa: E402
from repro_torch.net import routing as trouting  # noqa: E402


def _run_main(path: pathlib.Path, args: list[str]) -> str:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [str(path), *args]
    with contextlib.redirect_stdout(out):
        mod.main()
    sys.argv = argv
    return out.getvalue()


def main() -> None:
    mode, name, out_path, *args = sys.argv[1:]
    torch.set_num_threads(1)
    opt = RecordedOptimiser()
    milp: list[int] = []

    def watched(module):
        real = module.route_milp

        def route_milp(*a, **k):
            sol = real(*a, **k)
            milp.append(int(sol.metadata["milp_status"]))
            return sol

        return route_milp

    with pytest.MonkeyPatch.context() as mp:
        for module in (jrouting, trouting):
            mp.setattr(module, "route_milp", watched(module))
        if mode == "replay":
            jcompat.ensure_x64()
            opt.record(mp)
        jax_out = _run_main(ROOT / "examples" / f"{name}.py", args)
        if mode == "replay":
            opt.replay(mp)
        torch_out = _run_main(ROOT / "examples" / f"{name}_torch.py",
                              [*args, "--device", "cpu"])
    with open(out_path, "w") as f:
        json.dump({"jax": jax_out, "torch": torch_out,
                   "jax_calls": len(opt.jax_calls),
                   "port_calls": len(opt.port_calls),
                   "same_calls": opt.jax_calls == opt.port_calls,
                   "milp_status": milp, "pid": os.getpid()}, f)


if __name__ == "__main__":
    main()
