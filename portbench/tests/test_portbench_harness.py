"""The harness on the CPU, at the tiny cells of ``tiny.py``: cells,
configurations, mixes and metrics found by name; the result line's keys;
the window's bound; no card, no result; nothing of JAX loaded."""

import ast
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny.make_tree(tmp_path_factory.mktemp("checkout"))
    os.symlink(tiny.ROOT / "src", root / "src")
    return root


def test_cell_added_as_files_only(tree):
    """A configuration, a mix, a cell and a per-layer metric added as new
    files (and entries of BENCHMARK.json): found by name and run."""
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    (tree / "portbench/metrics/steps_seen.train.py").write_text(
        "def read(reading):\n    return float(len(reading['step_s']))\n")
    bench["per_layer"].append({
        "name": "steps_seen.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "launch/train.step_fn",
        "moves": "train_tokens_per_s", "workloads": ["tiny-dense-cell"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("tiny-dense-cell", tree)
    assert cell.traffic["name"] == "tiny-mix"
    assert cell.config["name"] == "tiny-dense"
    assert "steps_seen.train" in [m["name"] for m in cell.per_layer]
    assert "slstm_roofline.train" not in [m["name"] for m in cell.per_layer]
    result, _ = harness.run_cell(cell, 5, 0.2, True, CPU, time.perf_counter())
    assert result["metrics"]["steps_seen.train"]["value"] == result["attempted"]
    assert result["correct"]


def test_unknown_names_are_refused(tree):
    with pytest.raises(harness.SpecError):
        harness.load_cell("no-such-cell", tree)


def test_result_line_keys_and_window(tree, capsys):
    cell = harness.load_cell("tiny-xlstm-cell", tree)
    t0 = time.perf_counter()
    result, _ = harness.run_cell(cell, 2**31 + 11, 0.3, False, CPU, t0)
    harness.emit(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert result["correct"] and result["failed"] == 0
    assert set(line["metrics"]) == {"train_tokens_per_s", "peak_memory_gb",
                                    "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits["limits"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


def test_seconds_bound_the_window(tree):
    """The window is whole steps, the last begun before --seconds ran out."""
    cell = harness.load_cell("tiny-dense-cell", tree)
    _, out = harness.run_cell(cell, 9, 0.5, False, CPU, time.perf_counter())
    seen = out.reading
    steps = seen["step_s"]
    assert steps and sum(steps) - steps[-1] < 0.5 <= seen["window_s"]
    assert seen["window_s"] < 0.5 + steps[-1] + 0.05


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    r = _run(["portbench/run.py", "--workload", "qwen2-dpsgd10-2x4k",
              "--seed", "1", "--seconds", "1", "--trace", "0"], tiny.ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and the files under paths: no result."""
    root = tiny.make_tree(tmp_path)
    script = ("import sys, time, torch; sys.path[:] = [p for p in sys.path "
              "if 'src' not in p]; sys.path.insert(0, '.'); "
              "from portbench import harness; c = harness.load_cell("
              "'tiny-dense-cell'); print(harness.run_cell(c, 1, 0.1, False, "
              "torch.device('cpu'), time.perf_counter()))")
    r = _run(["-c", script], root, {"PYTHONPATH": ""})
    assert r.returncode != 0 and "repro_torch" in r.stderr
    assert "correct" not in r.stdout


def test_run_loads_nothing_of_jax(tree):
    script = ("import sys, time, torch; sys.path[:0] = ['.', 'src']; "
              "from portbench import harness; c = harness.load_cell("
              "'tiny-xlstm-cell'); harness.run_cell(c, 3, 0.1, True, "
              "torch.device('cpu'), time.perf_counter()); "
              "print(harness.forbidden_modules()); import types; "
              "sys.modules['repro.core'] = types.ModuleType('repro.core'); "
              "print(harness.forbidden_modules())")
    r = _run(["-c", script], tree)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-2:] == ["[]", "['repro']"]


def test_references_import_nothing_of_the_program():
    for path in (tiny.ROOT / "portbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro", "jax",
                                                  "jaxlib", "flax"), (path, name)
