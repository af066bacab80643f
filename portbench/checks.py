"""The comparison that decides ``correct`` for a training cell.

Relative gaps between the program and the reference that followed the
same first steps (``reference/dpsgd.py``):

* ``loss_gap``: the largest |L − L_ref| / |L_ref| of an agent's loss in a
  step, over every (step, agent), so that a fault in one agent's forward
  pass is not averaged away over the others;
* ``grad_gap``: over every (agent, leaf), the gap between the norm of the
  first gradient as the optimizer holds it (the momentum after step 1,
  which is that gradient) and the reference's, against the reference's
  norm of that leaf or of the agent's median leaf, whichever is larger;
  ``grad_median_gap`` the largest over the agents of their median leaf's
  gap;
* ``change_gap`` and ``change_median_gap``: the same two of each leaf's
  change over the steps, leaving out leaves whose reference gradient is
  under a thousandth of the agent's median leaf's (they move by round-off
  alone).

Every number is read in every run; a cell compares those its
``limits/<cell>.json`` gives a limit, and says there why. Non-finite
readings make a gap infinite.
"""

from __future__ import annotations

import math

import numpy as np

NOUGHT = 1e-3   # a leaf's first gradient under this share of the median's


def _leaf_gaps(prog: dict, ref: dict, keep: dict | None = None) -> tuple:
    """``([leaves, A] gaps, paths)`` of ``{path: [A] norms}`` against the
    reference's; leaves not kept read NaN."""
    paths = list(ref)
    table = np.stack([ref[p] for p in paths])          # [leaves, A]
    got = np.stack([np.asarray(prog[p], np.float64) for p in paths])
    base = np.maximum(table, np.median(table, axis=0))
    gaps = np.where(np.isfinite(got), np.abs(got - table) / base, math.inf)
    if keep is not None:
        gaps = np.where(np.stack([keep[p] for p in paths]), gaps, np.nan)
    return gaps, paths


def _worst(gaps: np.ndarray, paths: list) -> tuple[float, tuple, float]:
    """The largest gap, where it is, and the largest agent's median."""
    flat = np.where(np.isnan(gaps), -1.0, gaps)
    i, a = np.unravel_index(int(np.argmax(flat)), flat.shape)
    return (float(flat[i, a]), ("/".join(paths[i]), int(a)),
            float(np.nanmax(np.nanmedian(gaps, axis=0))))


def gaps(prog: dict, ref: dict) -> tuple[dict, dict]:
    """``(numbers, where)``: every gap, and for the worst-leaf ones their
    (leaf, agent), with the leaves left out of the change."""
    table = np.asarray(ref["loss"], np.float64)            # [steps, A]
    got = np.asarray(prog["loss"], np.float64)
    if got.shape != table.shape:
        got = np.full(table.shape, math.inf)
    loss = np.where(np.isfinite(got), np.abs(got - table) / np.abs(table),
                    math.inf)
    grad, grad_at, grad_median = _worst(*_leaf_gaps(prog["grad"], ref["grad"]))
    median = np.median(np.stack(list(ref["grad"].values())), axis=0)
    keep = {p: n >= NOUGHT * median for p, n in ref["grad"].items()}
    change, change_at, change_median = _worst(
        *_leaf_gaps(prog["change"], ref["change"], keep))
    numbers = {"loss_gap": float(loss.max()),
               "grad_gap": grad, "grad_median_gap": grad_median,
               "change_gap": change, "change_median_gap": change_median}
    where = {"loss_at": tuple(int(i) for i in
                              np.unravel_index(int(np.argmax(loss)), loss.shape)),
             "grad_at": grad_at,
             "change_at": change_at,
             "left_out": sorted("/".join(p) for p, k in keep.items()
                                if not k.all())}
    return numbers, where


def judge(numbers: dict, limits: dict) -> bool:
    """Whether every number given a limit is within it."""
    return all(numbers[k] <= limits[k] for k in limits)
