"""The port's five other examples (`examples/{quickstart,topology_design,
dynamic_network,serve_decode,elastic_failover}_torch.py`) against the
reference's, with the same flags and `--device cpu`, each pair in one
process (`tests/_torch_examples.py`), every process started at once.

Two runs of each design example:

* ``user`` — both scripts as a user runs them (the JAX package with x64
  off). The printed lines are equal but for the numbers that depend on
  where Adam ends: ρ, K(ρ) and the total hours (the last-bit chaos of
  `src/repro/core/weight_opt.py:65`, here also float32 against the port's
  float64), the seconds of wall time, and SCA's whole row — SCA's support
  is chosen from Adam's weights. Supports, link counts, τ̄ and τ of the
  other schemes are held equal without replay.
* ``replay`` — x64 on, every ``optimize_weights`` call of the JAX
  designer recorded and its result replayed to the port's
  (`_torch_design.RecordedOptimiser`): every printed line equal but the
  seconds of wall time, SCA's row included.

`serve_decode` masks its seconds and the sampled tokens (the two
packages' inits differ; the sample's length and range are asserted);
`elastic_failover` prints the reference's lines exactly (its service
designs by FMMD-P, which runs no Adam). No MILP of any run may stop at
its time limit (`dynamic_network` runs with `--milp-time-limit 600`): a
solve cut by the clock would depend on the machine."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 600
DESIGN = ("quickstart", "topology_design", "dynamic_network")
ARGS = {"dynamic_network": ["--milp-time-limit", "600"]}
RUNS = [("user", name) for name in (*DESIGN, "serve_decode",
                                     "elastic_failover")] + [
    ("replay", name) for name in DESIGN]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(mode, example): the helper's JSON report} — every run at once."""
    work = tmp_path_factory.mktemp("examples")
    # one thread a process: eight run at once
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "TMPDIR": str(work),
           "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1"}
    procs = {}
    for mode, name in RUNS:
        out = work / f"{mode}_{name}.json"
        procs[(mode, name)] = (out, subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_examples.py"),
             mode, name, str(out), *ARGS.get(name, [])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT), env=env))
    reports = {}
    for key, (out, proc) in procs.items():
        log = proc.communicate(timeout=TIMEOUT)[0]
        assert proc.returncode == 0, (key, log[-4000:])
        with open(out) as f:
            reports[key] = json.load(f)
    return reports


def _table(line: str, masked: set[int], whole_row: str | None = None):
    """A table row with the fields at ``masked`` replaced (all but the
    first for a row of ``whole_row``)."""
    fields = line.split()
    if fields and fields[0] == whole_row:
        return [fields[0]] + ["…"] * (len(fields) - 1)
    return ["…" if i in masked else f for i, f in enumerate(fields)]


def _masked(name: str, mode: str, stdout: str) -> list:
    lines = stdout.splitlines()
    if name == "quickstart" and mode == "user":
        return [re.sub(r"(rho|K\(rho\)|total)=\s*\S+", r"\1=…", line)
                for line in lines]
    if name == "topology_design":
        # method links rho tau_bar tau K(rho) total_h design_s
        masked = {2, 5, 6, 7} if mode == "user" else {7}
        return lines[:2] + [
            _table(line, masked, "sca" if mode == "user" else None)
            for line in lines[2:]]
    if name == "dynamic_network" and mode == "user":
        # ... total_h total_scen_h: the last two fields of a method row
        return lines[:2] + [
            _table(line, {len(line.split()) - 2, len(line.split()) - 1})
            for line in lines[2:]]
    if name == "serve_decode":
        return [re.sub(r"\d+\.\d+s|\(\S+ tok/s\)|sample: .*", "…", line)
                for line in lines]
    return lines


@pytest.mark.parametrize("mode,name", RUNS, ids=[f"{m}-{n}" for m, n in RUNS])
def test_printed_lines_are_the_references(runs, mode, name):
    report = runs[(mode, name)]
    want = _masked(name, mode, report["jax"])
    got = _masked(name, mode, report["torch"])
    assert len(want) >= 2
    assert got == want


@pytest.mark.parametrize("name", DESIGN)
def test_replay_hands_the_port_the_references_calls(runs, name):
    """The port's designer asked for exactly the optimisations the
    reference's made, in the same order, arguments bitwise."""
    report = runs[("replay", name)]
    assert report["jax_calls"] > 0
    assert report["same_calls"]
    assert report["port_calls"] == report["jax_calls"]


@pytest.mark.parametrize("name", DESIGN)
def test_user_run_holds_supports_and_tau(runs, name):
    """As a user runs them, the supports and τ the scripts print for the
    schemes whose support Adam does not choose are the reference's."""
    report = runs[("user", name)]
    rows = {}
    for side in ("jax", "torch"):
        rows[side] = {
            line.split()[0].rstrip(":"): line for line in
            report[side].splitlines()
            if line.split() and line.split()[0].rstrip(":") in (
                "clique", "ring", "prim", "fmmd-wp")}
    assert rows["torch"].keys() == rows["jax"].keys()
    assert {"clique", "ring", "fmmd-wp"} <= rows["jax"].keys()
    for method, line in rows["jax"].items():
        got = rows["torch"][method]
        if name == "quickstart":
            for key in ("links", "tau"):
                pat = rf"{key}=\s*(\S+)"
                assert re.search(pat, got)[1] == re.search(pat, line)[1]
            assert got.split("[")[1] == line.split("[")[1]  # routing
        elif name == "topology_design":
            assert got.split()[1] == line.split()[1]      # links
            assert got.split()[3:5] == line.split()[3:5]  # tau_bar, tau
        else:
            assert got.split()[1:5] == line.split()[1:5]  # the τ columns


def test_no_milp_stopped_at_its_time_limit(runs):
    statuses = [s for report in runs.values() for s in report["milp_status"]]
    assert statuses and set(statuses) == {0}


def test_serve_decode_sample(runs):
    """The sampled tokens: as many as asked for, inside the vocabulary."""
    from repro_torch.configs.base import get_config

    vocab = get_config("gemma2-2b", smoke=True).vocab_size
    for side in ("jax", "torch"):
        line = runs[("user", "serve_decode")][side].splitlines()[-1]
        sample = json.loads(line.split("sample: ", 1)[1])
        assert len(sample) == 16
        assert all(0 <= t < vocab for t in sample)
