"""The port's static checkers (`repro_torch.analysis`), against the JAX
package's (`repro.analysis`) where they share a rule:

* `common`'s waiver handling gives the reference's `(unwaived, waived)`
  lists on the same findings and waiver files (malformed, unused and
  scope-specific waivers included);
* `determinism`, pointed at the reference's trees (its own negative
  fixture `tests/fixtures/lint_negative`, the JAX package itself, and a
  tree planting every shared code), gives the reference's findings for
  every shared numpy/stdlib code;
* the port's negative tree `tests/fixtures/lint_negative_torch` trips
  every code of every checker, and each checker is green on the repo;
* the CLI exits 0 on the repo, 1 on the negative tree, 2 on an unknown
  checker name."""

import dataclasses
import textwrap
from pathlib import Path

import pytest

from repro.analysis import common as jcommon
from repro.analysis import determinism as jdeterminism
from repro_torch.analysis import (
    common,
    contracts_static,
    determinism,
    docs_check,
    dtypes,
    parity,
)
from repro_torch.analysis.__main__ import CHECKERS, main, run

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "lint_negative_torch"
JAX_FIXTURE = REPO / "tests" / "fixtures" / "lint_negative"
# The reference's codes with no counterpart in the port.
JAX_ONLY = {"fresh-prng-key"}


def codes(findings):
    return {f.code for f in findings}


def sites(findings):
    return sorted((f.path, f.line, f.scope, f.code) for f in findings)


# ---------------------------------------------------------------------------
# common: waivers, against the reference
# ---------------------------------------------------------------------------

_FINDINGS = (
    ("determinism", "src/x/a.py", 3, "f", "time-read"),
    ("determinism", "src/x/a.py", 9, "f", "time-read"),
    ("determinism", "src/x/a.py", 14, "g", "time-read"),
    ("dtypes", "src/x/b.py", 5, "<module>", "narrow-int-dtype"),
    ("parity", "src/x/c.py", 1, "h_reference", "unregistered-reference"),
)
_WAIVER_FILES = {
    "valid": "determinism src/x/a.py f time-read -- telemetry only\n",
    "scope-specific": (
        "# covers f, not g\n"
        "determinism src/x/a.py f time-read -- telemetry only\n"
        "dtypes src/x/b.py <module> narrow-int-dtype -- bounded ids\n"),
    "malformed": (
        "determinism src/x/a.py f time-read\n"
        "dtypes src/x/b.py narrow-int-dtype -- three fields\n"
        "dtypes src/x/b.py <module> narrow-int-dtype --   \n"),
    "unused": (
        "determinism src/x/a.py gone time-read -- fixed since\n"
        "parity src/x/c.py h_reference unregistered-reference -- kept\n"),
    "missing": None,
}


@pytest.mark.parametrize("case", sorted(_WAIVER_FILES))
def test_waivers_match_the_reference(tmp_path, case):
    path = tmp_path / "waivers.txt"
    if _WAIVER_FILES[case] is not None:
        path.write_text(_WAIVER_FILES[case])
    got = []
    for mod in (jcommon, common):
        findings = [
            mod.Finding(checker=c, path=p, line=n, scope=s, code=k,
                        message=f"{k} at {p}:{n}")
            for c, p, n, s, k in _FINDINGS]
        waivers, bad = mod.load_waivers(path)
        unwaived, waived = mod.apply_waivers(findings + bad, waivers, path)
        got.append((
            [dataclasses.astuple(w) for w in waivers],
            [dataclasses.astuple(f) for f in unwaived],
            [dataclasses.astuple(f) for f in waived],
            [f.waiver_key for f in unwaived],
        ))
    assert got[1] == got[0]
    if case == "scope-specific":
        assert ("determinism", "src/x/a.py", 14, "g", "time-read") in [
            t[:5] for t in got[1][1]]


def test_parse_file_skips_a_syntax_error_like_the_reference(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(:\n")
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert common.parse_file(bad) is None is jcommon.parse_file(bad)
    assert common.parse_file(good) is not None


# ---------------------------------------------------------------------------
# determinism: the reference's findings on the reference's trees
# ---------------------------------------------------------------------------


def _write(tmp_path: Path, rel: str, body: str) -> Path:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))
    return p


_SHARED_CODES_TREE = """
    import datetime, os, random, time, uuid
    import numpy as np

    def f(xs, seed):
        a = np.random.rand(3)
        b = np.random.default_rng()
        c = np.random.default_rng(time.time_ns())
        d = np.random.Generator()
        e = random.shuffle(xs)
        g = random.Random()
        h = random.Random(seed)
        i = os.environ["HOME"], os.getenv("X"), os.urandom(4)
        j = uuid.uuid4(), datetime.datetime.now(), time.monotonic()
        k = [x for x in set(xs)] + list({1, 2})
        for y in frozenset(xs):
            pass
        return sorted(set(xs)), np.random.default_rng(seed)
"""


def _jax_tree(tmp_path):
    _write(tmp_path, "src/repro/net/shared.py", _SHARED_CODES_TREE)
    _write(tmp_path, "src/repro/core/more.py", """
        import numpy as np
        rng = np.random.default_rng(0)
        def g():
            return np.random.choice([1, 2])
    """)
    return tmp_path


@pytest.mark.parametrize("tree", ["jax_fixture", "jax_package", "shared"])
def test_determinism_gives_the_references_findings(tmp_path, monkeypatch,
                                                   tree):
    root = {"jax_fixture": JAX_FIXTURE, "jax_package": REPO,
            "shared": None}[tree] or _jax_tree(tmp_path)
    want = [f for f in jdeterminism.check(root) if f.code not in JAX_ONLY]
    # the port's checker, pointed at the reference's directories
    monkeypatch.setattr(determinism, "SCAN_DIRS", jdeterminism.SCAN_DIRS)
    got = determinism.check(root)
    assert sites(got) == sites(want)
    assert [f.message for f in sorted(got, key=lambda f: (f.line, f.code))] \
        == [f.message for f in sorted(want, key=lambda f: (f.line, f.code))]
    if tree == "shared":
        assert codes(want) == {
            "global-numpy-rng", "unseeded-default-rng", "stdlib-random",
            "unseeded-random-ctor", "impure-prng-seed", "time-read",
            "env-read", "os-entropy", "set-iteration-order"}
    if tree == "jax_fixture":
        assert codes(got) == {"unseeded-default-rng"}


def test_determinism_torch_rules(tmp_path):
    _write(tmp_path, "src/repro_torch/core/t.py", """
        import os, time
        import torch

        def f(x, seed, gen, dev):
            ok = torch.Generator(device=dev).manual_seed(seed)
            a = torch.rand(3, generator=ok)
            b = torch.randperm(5, generator=gen)
            c = x.normal_(generator=ok)
            d = torch.randn(3)
            e = x.uniform_()
            g = torch.Generator(device=dev)
            torch.cuda.manual_seed_all(seed)
            h = ok.manual_seed(os.getpid() + time.time_ns())
            return torch.multinomial(x, 2)
    """)
    got = determinism.check(tmp_path)
    assert sorted((f.line, f.code) for f in got) == [
        (10, "global-torch-rng"), (11, "global-torch-rng"),
        (12, "unseeded-torch-generator"), (13, "global-torch-rng"),
        (14, "impure-prng-seed"), (14, "time-read"),
        (15, "global-torch-rng")]


# ---------------------------------------------------------------------------
# dtypes: torch's names
# ---------------------------------------------------------------------------


def test_dtypes_torch_rules(tmp_path):
    _write(tmp_path, "src/repro_torch/net/p.py", """
        import numpy as np
        import torch

        def f(x, a, n):
            y = x.to(torch.bfloat16), x.to(torch.half), torch.short
            z = torch.arange(n), torch.linspace(0, 1, n), torch.tensor(a)
            ok = torch.zeros(n, dtype=torch.float64), torch.as_tensor(a)
            ok2 = torch.from_numpy(a), torch.zeros_like(x), np.float64
            return torch.full((n,), 1.0, dtype=x.dtype), torch.int64
    """)
    got = sorted((f.line, f.code) for f in dtypes.check(tmp_path))
    assert got == [
        (6, "narrow-float-dtype"), (6, "narrow-float-dtype"),
        (6, "narrow-int-dtype"), (7, "implicit-torch-dtype"),
        (7, "implicit-torch-dtype"), (7, "implicit-torch-dtype")]


def test_dtypes_ignores_the_learning_half(tmp_path):
    _write(tmp_path, "src/repro_torch/core/gossip.py",
           "import torch\nx = torch.float32\n")
    assert dtypes.check(tmp_path) == []


# ---------------------------------------------------------------------------
# The negative tree: every code of every checker
# ---------------------------------------------------------------------------

_FIXTURE_CODES = {
    "determinism": {
        "global-numpy-rng", "unseeded-default-rng", "stdlib-random",
        "unseeded-random-ctor", "impure-prng-seed", "time-read", "env-read",
        "os-entropy", "set-iteration-order", "global-torch-rng",
        "unseeded-torch-generator"},
    "dtypes": {"narrow-float-dtype", "narrow-int-dtype",
               "narrow-dtype-string", "implicit-torch-dtype"},
    "parity": {"unregistered-reference", "stale-manifest-entry",
               "missing-parity-test", "parity-test-lacks-symbol",
               "malformed-manifest"},
    "contracts": {"missing-contract-hook", "contract-class-missing"},
    "docs": {"missing-architecture-doc"},
    "tracelint": {"implicit-host-sync", "narrow-float-in-trace",
                  "uncounted-host-sync", "op-budget-exceeded",
                  "sync-budget-exceeded", "trace-error", "missing-budget",
                  "stale-budget-entry", "malformed-budget"},
}


@pytest.mark.parametrize("name", sorted(_FIXTURE_CODES))
def test_negative_tree_trips_every_code(name):
    assert codes(CHECKERS[name](FIXTURE)) == _FIXTURE_CODES[name]


def test_negative_tree_trips_the_waiver_codes():
    unwaived, waived = run(FIXTURE, ["determinism"])
    assert {"malformed-waiver", "unused-waiver"} <= codes(unwaived)
    assert not waived


def test_negative_tree_implicit_syncs_are_the_planted_ones():
    got = [f for f in CHECKERS["tracelint"](FIXTURE)
           if f.code == "implicit-host-sync"]
    assert sorted((f.line, f.scope) for f in got) == [
        (16, "_step"), (18, "_step"), (25, "_run_batch"),
        (26, "_run_batch"), (26, "_run_batch")]


# ---------------------------------------------------------------------------
# The repo: every checker green
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CHECKERS))
def test_checker_is_green_on_the_repo(name):
    unwaived, _ = run(REPO, [name])
    # an unused waiver of another checker is not this checker's business
    assert [f.render() for f in unwaived
            if f.checker == name or f.code == "malformed-waiver"] == []


def test_every_waiver_is_used_and_reasoned():
    unwaived, waived = run(REPO, list(CHECKERS))
    assert unwaived == []
    waivers, bad = common.load_waivers(
        REPO / "src/repro_torch/analysis" / common.WAIVERS_FILENAME)
    assert not bad and all(w.reason for w in waivers)
    assert {f.waiver_key for f in waived} == {w.key for w in waivers}


def test_the_six_references_are_registered():
    entries, bad = parity.load_manifest(
        REPO / "src/repro_torch/analysis" / parity.MANIFEST_FILENAME)
    assert not bad
    assert sorted((e.src_file, e.reference) for e in entries) == sorted(
        parity._reference_defs(REPO)) == sorted([
            ("src/repro_torch/net/simulator.py", "_simulate_reference"),
            ("src/repro_torch/net/routing.py",
             "_route_congestion_aware_reference"),
            ("src/repro_torch/net/categories.py",
             "_compute_categories_reference"),
            ("src/repro_torch/net/categories.py",
             "_compile_category_incidence_reference"),
            ("src/repro_torch/net/torch_engine.py",
             "_rollout_batch_reference"),
            ("src/repro_torch/models/moe.py", "apply_dense_reference")])
    assert all(t.startswith("tests/test_torch_") for e in entries
               for t in e.tests)


def test_contract_hooks_cover_every_validator():
    from repro_torch.analysis.contracts import VALIDATORS

    assert contracts_static.check(REPO) == []
    assert set(VALIDATORS) == {"BranchIncidence", "CategoryIncidence",
                               "DeviceIncidence", "_FlatCategories"}


def test_docs_flags_an_unlisted_module_only(tmp_path):
    _write(tmp_path, "src/repro_torch/net/listed.py", "x = 1\n")
    _write(tmp_path, "src/repro_torch/net/unlisted.py", "x = 1\n")
    _write(tmp_path, "src/repro_torch/net/_private.py", "x = 1\n")
    _write(tmp_path, "docs/architecture_torch.md", "`listed.py` is here\n")
    got = docs_check.check(tmp_path)
    assert [(f.code, f.path) for f in got] == [
        ("undocumented-module", "src/repro_torch/net/unlisted.py")]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_exits_zero_on_the_repo(capsys):
    assert main(["--all"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_exits_one_on_the_negative_tree_and_names_every_code(capsys):
    assert main(["--all", "--root", str(FIXTURE)]) == 1
    out = capsys.readouterr().out
    for want in set().union(*_FIXTURE_CODES.values()):
        assert f"/{want}]" in out, want


def test_cli_selects_checkers(capsys):
    assert main(["--dtypes", "--root", str(FIXTURE)]) == 1
    out = capsys.readouterr().out
    assert "[dtypes/" in out and "[determinism/" not in out
    assert main(["contracts", "--root", str(FIXTURE)]) == 1
    assert "[contracts/" in capsys.readouterr().out


def test_cli_unknown_checker_exits_2(capsys):
    assert main(["no-such-checker"]) == 2
    assert "unknown checker" in capsys.readouterr().err
