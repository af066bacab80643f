"""The port's trace lint (`repro_torch.analysis.tracelint`) on the CPU.

* the registered targets (`tracelint_targets.py`: `rollout-batch`,
  `phased-scan`, `stochastic-price`) are clean: every floating output of
  the ops they dispatch is float64, the device→host reads the dispatch
  mode sees equal the rise of `torch_engine.sync_count()`, within their
  budgets (with headroom);
* a float32 op, an uncounted `.item()` and an over-budget target each give
  their code — on planted targets and injected into the engine itself;
* malformed, duplicate, stale and missing budget lines give their codes;
* the AST pass flags uncounted reads in `_run_batch`'s call closure and
  exempts the counted ones;
* `collect_metrics` reads ops and reads per water-fill round."""

import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import tracelint
from repro_torch.analysis.tracelint import (
    BudgetEntry,
    TraceCase,
    TraceTarget,
)
from repro_torch.net import torch_engine

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def codes(findings):
    return {f.code for f in findings}


@pytest.fixture(scope="module")
def registered():
    findings, records = tracelint.check_targets(REPO, "cpu")
    return findings, records


# ---------------------------------------------------------------------------
# The registered targets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name",
                         ["rollout-batch", "phased-scan", "stochastic-price"])
def test_registered_target_is_clean(registered, name):
    findings, records = registered
    assert [f.render() for f in findings] == []
    assert records[name]
    for rec in records[name]:
        assert rec.total_ops > 0
        assert not rec.narrow
        assert rec.total_host_reads == rec.counted > 0


@pytest.mark.parametrize("case", ["line2-r4", "line2-r8"])
def test_rollout_batch_reads_equal_sync_count(case):
    """The dispatch-seen device→host reads of `rollout-batch` are the
    engine's count: one `.any()` a loop test plus the results copy."""
    target = next(t for t in tracelint._load_targets(REPO)[0]
                  if t.name == "rollout-batch")
    fn, args = next(c for c in target.cases if c.label == case).make(CPU)
    torch_engine.reset_sync_count()
    rec = tracelint.trace(fn, args, CPU)
    assert rec.total_host_reads == rec.counted == torch_engine.sync_count()
    assert rec.host_reads == {
        "aten._local_scalar_dense.default": rec.counted - 1,
        "aten._to_copy.default": 1}


def test_budgets_have_headroom(registered):
    _, records = registered
    budgets, bad = tracelint.load_manifest(REPO / tracelint.MANIFEST_REL_PATH)
    assert not bad and set(budgets) == set(records)
    for name, recs in records.items():
        ops = max(r.total_ops for r in recs)
        reads = max(r.total_host_reads for r in recs)
        assert ops * 1.2 <= budgets[name].max_ops, name
        assert reads * 1.2 <= budgets[name].max_syncs, name


# ---------------------------------------------------------------------------
# Faults give their codes
# ---------------------------------------------------------------------------


def _target(run, x=None):
    x = torch.ones(4, dtype=torch.float64) if x is None else x
    return TraceTarget("t", "planted.py", "t",
                       (TraceCase("c", lambda device: (run, (x,))),))


def _lint(run, budget=(1000, 100), x=None):
    budgets = {"t": BudgetEntry("t", budget[0], budget[1], 1)}
    return tracelint._trace_target(_target(run, x), budgets, CPU)[0]


def test_float64_target_is_clean():
    assert _lint(lambda x: (x * 2).sum()) == []


def test_float32_op_gives_narrow_float_in_trace():
    got = _lint(lambda x: x.float() * 2)
    assert codes(got) == {"narrow-float-in-trace"}
    assert "float32" in got[0].message and "(+1 more" in got[0].message


def test_python_float_against_a_float32_default_is_seen():
    """torch.tensor of Python floats takes torch's float32 default."""
    assert codes(_lint(lambda x: x + torch.tensor([0.5]))) == {
        "narrow-float-in-trace"}


@pytest.mark.parametrize("read", ["item", "bool", "float", "cpu", "if",
                                  "nonzero", "bool_index"])
def test_uncounted_read_gives_uncounted_host_sync(read):
    def run(x):
        y = x * 2
        if read == "item":
            return y.sum().item()
        if read == "bool":
            return bool(y.any())
        if read == "float":
            return float(y.max())
        if read == "cpu":
            return y.to("cpu", copy=True)
        if read == "if":
            return 1 if y.sum() > 0 else 0
        if read == "nonzero":
            return torch.nonzero(y)
        return y[y > 1]

    got = _lint(run)
    assert codes(got) == {"uncounted-host-sync"}
    assert "rose by 0" in got[0].message


def test_a_host_tensors_read_is_no_device_read():
    """A tensor the host handed in (`torch.from_numpy`) is not a device
    value: reading it back is no synchronisation on the card either."""
    host = torch.from_numpy(np.array([4.0]))
    assert codes(_lint(lambda x: x.item(), x=host)) == set()
    assert codes(_lint(lambda x: (x + 1).item(), x=host)) == {
        "uncounted-host-sync"}


def test_counted_read_is_clean_and_budgeted():
    run = lambda x: torch_engine._read_any(x > 0)  # noqa: E731
    assert _lint(run) == []
    assert codes(_lint(run, budget=(1000, 0))) == {"sync-budget-exceeded"}


def test_over_budget_gives_op_budget_exceeded():
    def run(x):
        for _ in range(10):
            x = x + 1
        return x

    got = _lint(run, budget=(9, 100))
    assert codes(got) == {"op-budget-exceeded"}
    assert "dispatches 10 op(s), budget is 9" in got[0].message
    assert _lint(run, budget=(10, 100)) == []


def test_failing_case_gives_trace_error():
    def run(x):
        raise ValueError("broken")

    assert codes(_lint(run)) == {"trace-error"}


def test_uncounted_item_in_the_engine_is_caught(monkeypatch):
    """An `.item()` injected into the water-fill's table reduction: the
    registered `rollout-batch` target reports it."""
    real = torch_engine._table_any

    def leaky(mask, cols):
        out = real(mask, cols)
        out.any().item()
        return out

    monkeypatch.setattr(torch_engine, "_table_any", leaky)
    findings, _ = tracelint.check_targets(REPO, "cpu")
    assert "uncounted-host-sync" in codes(findings)
    assert all(f.code in ("uncounted-host-sync", "sync-budget-exceeded")
               for f in findings)


def test_float32_in_the_engine_is_caught(monkeypatch):
    """A float32 drain injected into the water-fill: every target sees
    it."""
    real = torch_engine._table_count

    def narrow(mask, cols, dtype):
        out = real(mask, cols, dtype)
        out.to(torch.float32)
        return out

    monkeypatch.setattr(torch_engine, "_table_count", narrow)
    findings, _ = tracelint.check_targets(REPO, "cpu")
    assert {f.scope for f in findings if f.code == "narrow-float-in-trace"
            } == {"simulate_rollout_batch", "_simulate_batch",
                  "StochasticTau.price"}


# ---------------------------------------------------------------------------
# The budget manifest
# ---------------------------------------------------------------------------


def test_malformed_and_duplicate_budget_lines(tmp_path):
    path = tmp_path / "tracelint_manifest.txt"
    path.write_text(
        "# comment\n"
        "a 10 2\n"
        "b 10\n"            # missing the read budget
        "c ten 2\n"         # not a number
        "a 20 3\n"          # duplicate
        "d 5 1  # trailing comment\n")
    budgets, findings = tracelint.load_manifest(path)
    assert sorted(budgets) == ["a", "d"]
    assert budgets["a"].max_ops == 10 and budgets["d"].max_syncs == 1
    assert [(f.code, f.line) for f in findings] == [
        ("malformed-budget", 3), ("malformed-budget", 4),
        ("malformed-budget", 5)]
    assert "duplicate target" in findings[2].message


def test_stale_and_missing_budget_entries(tmp_path):
    registry = tmp_path / tracelint.TARGETS_REL_PATH
    registry.parent.mkdir(parents=True)
    registry.write_text(textwrap.dedent("""
        import torch
        from repro_torch.analysis.tracelint import TraceCase, TraceTarget

        def make(device):
            return (lambda x: x * 2), (torch.ones(2, dtype=torch.float64),)

        TARGETS = (TraceTarget("kept", "k.py", "k", (TraceCase("c", make),)),
                   TraceTarget("new", "n.py", "n", (TraceCase("c", make),)))
    """))
    (tmp_path / tracelint.MANIFEST_REL_PATH).write_text(
        "kept 10 0\nghost 10 0\n")
    findings, records = tracelint.check_targets(tmp_path, "cpu")
    assert sorted((f.code, f.scope) for f in findings) == [
        ("missing-budget", "new"), ("stale-budget-entry", "ghost")]
    assert records["kept"][0].total_ops == 1


def test_registry_import_error(tmp_path):
    registry = tmp_path / tracelint.TARGETS_REL_PATH
    registry.parent.mkdir(parents=True)
    registry.write_text("raise ImportError('planted')\n")
    findings, _ = tracelint.check_targets(tmp_path, "cpu")
    assert codes(findings) == {"targets-import-error"}
    registry.write_text("TARGETS = ()\n")
    tracelint._TARGETS_CACHE.clear()
    assert codes(tracelint.check_targets(tmp_path, "cpu")[0]) == {
        "targets-import-error"}


# ---------------------------------------------------------------------------
# The AST pass
# ---------------------------------------------------------------------------


def _ast_findings(tmp_path, body):
    p = tmp_path / "src/repro_torch/net/engine.py"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))
    return sorted((f.line, f.scope) for f in
                  tracelint._sync_ast_pass(tmp_path))


def test_ast_pass_exempts_counted_reads_and_static_reads(tmp_path):
    assert _ast_findings(tmp_path, """
        import numpy as np
        import torch
        _syncs = 0

        def _read(m):
            global _syncs
            _syncs += 1
            return bool(m.any())

        def _loop(x, n):
            rows, cols = x.shape
            if x.ndim > 1 and n > 2 and len(x) > 0:
                x = x + 1
            while _read(x > 0):
                x = x - 1
            return x

        def _run_batch(table, n):
            x = torch.from_numpy(np.asarray(table))
            y = _loop(x, int(n))
            global _syncs
            _syncs += 1
            return y.to("cpu", copy=True).numpy()
    """) == []


def test_ast_pass_flags_uncounted_reads_in_the_closure(tmp_path):
    assert _ast_findings(tmp_path, """
        import torch

        def _deep(v):
            return v.tolist()

        def _step(x, cols):
            c = cols[0]
            if not (c > 0).all():
                x = x + c
            return _deep(x * 2), x.cpu()

        def _run_batch(table):
            cols = list(torch.from_numpy(table))
            x = torch.zeros(3, dtype=torch.float64)
            a, b = _step(x, cols)
            ok = [t for t in cols if t.sum()]
            n = float(a[0]) if x.max() else 0.0
            return ok, n

        def elsewhere(t):
            return t.item()
    """) == [(5, "_deep"), (9, "_step"), (11, "_step"),
             (17, "_run_batch"), (18, "_run_batch")]


def test_ast_pass_is_clean_on_the_engine():
    assert tracelint._sync_ast_pass(REPO) == []


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def test_collect_metrics_covers_every_target():
    metrics = tracelint.collect_metrics(REPO, "cpu")
    for key in ("rollout_batch", "phased_scan", "stochastic_price"):
        assert metrics[f"ops_{key}"] > 0
        assert metrics[f"host_reads_{key}"] > 0
    assert metrics["waterfill_rounds"] > 0
    assert 10 < metrics["waterfill_ops_per_round"] < 200
    # one read a loop test, a test every two rounds, plus each call's
    # last (failing) test
    assert 0.5 <= metrics["waterfill_host_reads_per_round"] <= 1.0
    assert metrics["waterfill_output_bytes_per_round"] > 0


def test_watched_function_is_put_back():
    real = torch_engine._waterfill
    target = next(t for t in tracelint._load_targets(REPO)[0]
                  if t.name == "rollout-batch")
    fn, args = target.cases[0].make(CPU)
    rec, per_round = tracelint.trace_rounds(fn, args, CPU)
    assert torch_engine._waterfill is real
    assert rec.regions["_waterfill"][0] == per_round[
        "waterfill_ops_per_round"] * per_round["waterfill_rounds"]
