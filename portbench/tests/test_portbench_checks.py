"""The comparison that decides ``correct``: a sound run passes; each fault a
training cell can have, planted in the program under the rest of a run
(the chip's look skipped), and the control fail."""

import math
import os
import time

import numpy as np
import pytest
import torch

from portbench import checks, harness
from portbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny.make_tree(tmp_path_factory.mktemp("checkout"))
    os.symlink(tiny.ROOT / "src", root / "src")
    return root


@pytest.mark.parametrize("cell", ["tiny-dense-cell", "tiny-xlstm-cell"])
@pytest.mark.parametrize("fault", [None, "frozen", "half_batch", "no_gossip",
                                   "other_rows"])
def test_faults_are_refused(tree, cell, fault):
    result, _ = harness.run_cell(harness.load_cell(cell, tree), 21, 0.05,
                                 False, CPU, time.perf_counter(), fault=fault)
    assert result["correct"] is (fault is None)


def test_one_agents_fault_shows_in_its_loss(tree):
    """Agent 0 trained on agent 1's rows: its own loss departs, the others'
    do not."""
    _, out = harness.run_cell(harness.load_cell("tiny-dense-cell", tree), 21,
                              0.0, False, CPU, time.perf_counter(),
                              fault="other_rows")
    gap = np.abs(np.subtract(out.prog["loss"], out.ref["loss"]))
    assert out.where["loss_at"][1] == 0 and gap[:, 0].min() > 1e-4
    assert gap[0, 1:].max() < 1e-5


@pytest.mark.parametrize("cell", ["tiny-dense-cell", "tiny-xlstm-cell"])
def test_control_is_refused(tree, cell):
    """The reference one precision down (float8 products) in the program's
    place fails the tiny cell's limits."""
    c = harness.load_cell(cell, tree)
    result, out = harness.run_cell(c, 23, 0.0, False, CPU, time.perf_counter(),
                                   control=True)
    assert result["correct"]
    assert not checks.judge(out.control, c.limits["limits"])


def _readings(change):
    grad = {("a",): np.array([1.0, 2.0]), ("b",): np.array([3.0, 1.0]),
            ("c",): np.array([1e-9, 1e-9])}
    return {"loss": [[2.0, 1.0], [1.5, 1.0]], "grad": grad, "change": change}


def test_gaps_by_hand():
    ref = _readings({("a",): np.array([1.0, 1.0]), ("b",): np.array([2.0, 1.0]),
                     ("c",): np.array([1e-9, 1e-9])})
    prog = _readings({("a",): np.array([1.1, 1.0]), ("b",): np.array([2.0, 1.0]),
                      ("c",): np.array([5.0, 5.0])})
    prog["loss"] = [[2.0, 1.0], [1.5, 1.1]]
    numbers, where = checks.gaps(prog, ref)
    # the worst (step, agent), not the mean over the agents (0.05)
    assert numbers["loss_gap"] == pytest.approx(0.1)
    assert where["loss_at"] == (1, 1)
    assert numbers["grad_gap"] == 0.0
    # leaf c's gradient is nought: left out of the change
    assert numbers["change_gap"] == pytest.approx(0.1)
    assert where["left_out"] == ["c"] and where["change_at"] == ("a", 0)
    assert numbers["change_median_gap"] == pytest.approx(0.05)


def test_non_finite_is_refused():
    ref = _readings({("a",): np.ones(2), ("b",): np.ones(2), ("c",): np.ones(2)})
    prog = _readings({("a",): np.array([math.nan, 1.0]), ("b",): np.ones(2),
                      ("c",): np.ones(2)})
    prog["loss"] = [[math.nan, 1.0], [1.5, 1.0]]
    numbers, _ = checks.gaps(prog, ref)
    assert numbers["loss_gap"] == math.inf and numbers["change_gap"] == math.inf
    assert not checks.judge(numbers, {"loss_gap": 1.0})
