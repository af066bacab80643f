"""The port's trainer example (`examples/train_dfl_torch.py`) against the
reference's (`examples/train_dfl.py`), both run as a user runs them.

Each pricing mode runs both scripts with the same flags (the `batched`
pricing engine on both sides, the port's kernels through their plain
versions on the CPU): the per-round τ, design labels, pricing tags and
modeled wall-clock equal the reference's at rtol 1e-9, the agent's
failure and the redesign at the same round included; the losses are
finite (the two packages' inits differ, so they are not compared); and
the printed lines are the reference's but for those numbers."""

import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("static", "phased", "stochastic")
ARGS = ["--steps", "6", "--fail-agent-at", "3", "--ckpt-every", "2",
        "--agents", "4", "--width-scale", "0.08", "--engine", "batched"]
TIMEOUT = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(side, mode): (stdout, log)} — the six runs started at once."""
    work = tmp_path_factory.mktemp("examples")
    # one thread a process: six run at once
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "TMPDIR": str(work),
           "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    procs = {}
    for mode in MODES:
        for side, script, extra in (
                ("jax", "train_dfl.py", []),
                ("torch", "train_dfl_torch.py", ["--device", "cpu"])):
            log = work / f"{side}_{mode}.json"
            procs[(side, mode)] = (log, subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / script), *ARGS,
                 "--pricing", mode, "--log-json", str(log), *extra],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=str(ROOT), env=env))
    out = {}
    for key, (log, proc) in procs.items():
        stdout = proc.communicate(timeout=TIMEOUT)[0]
        assert proc.returncode == 0, stdout[-4000:]
        with open(log) as f:
            out[key] = (stdout, json.load(f)["records"])
    return out


@pytest.mark.parametrize("mode", MODES)
def test_rounds_equal_the_references(runs, mode):
    want, got = runs[("jax", mode)][1], runs[("torch", mode)][1]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for key in ("step", "design", "pricing", "gossip_rounds"):
            assert g[key] == w[key], (key, g, w)
        for key in ("tau", "wall_clock"):
            assert math.isclose(g[key], w[key], rel_tol=1e-9), (key, g, w)
        assert math.isfinite(g["loss"])
    # the redesign after the failure at round 3, its τ charged from there
    assert [r["design"] for r in got] == ["FMMD-WP"] * 3 + [
        "fmmd-wp-redesign"] * 3
    running = 0.0
    for r in got:
        running += r["tau"]
        assert r["wall_clock"] == running


_NUMBERS = (r"loss=\S+", r"consensus=\S+", r"done in \d+s",
            r"checkpoints at \S+", r"log: \S+")


def _masked(stdout: str) -> list[str]:
    """The printed lines, the numbers that differ by design masked (loss,
    consensus, seconds of wall time, the checkpoint and log paths)."""
    lines = []
    for line in stdout.splitlines():
        if "Warning" in line or line.startswith(" "):
            continue
        for pattern in _NUMBERS:
            line = re.sub(pattern, pattern.split("\\")[0] + "…", line)
        lines.append(line)
    return lines


@pytest.mark.parametrize("mode", MODES)
def test_printed_lines_are_the_references(runs, mode):
    want, got = _masked(runs[("jax", mode)][0]), _masked(
        runs[("torch", mode)][0])
    assert got == want
    assert any(line.startswith("redesign: ") for line in got)
