"""The comparison that decides ``correct`` for a training cell.

The program's first steps and the reference's are read the same way:
each step's loss, each leaf's first gradient as the optimizer takes it,
and each leaf's change after the last step.  Three numbers come of that:

- ``loss_gap``: the largest ``|loss − ref| / |ref|`` over the steps;
- ``grad_gap``: over the leaves, the largest gap between the program's
  gradient norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``change_gap``: the same of the changes, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (they
  move by round-off alone).

A reading that is not finite gives an infinite gap.
"""
from __future__ import annotations

import math
import statistics

#: a leaf moves by round-off alone where its reference gradient is under
#: this share of the median leaf's
STILL_LEAF = 1e-3


def _finite(*values) -> bool:
    return all(math.isfinite(v) for v in values)


def leaf_gap(prog: dict, ref: dict, skip=()) -> float:
    if set(prog) != set(ref):
        return math.inf
    med = statistics.median(ref.values())
    worst = 0.0
    for k, r in ref.items():
        if k in skip:
            continue
        p = prog[k]
        if not _finite(p, r):
            return math.inf
        worst = max(worst, abs(p - r) / max(abs(r), abs(med), 1e-30))
    return worst


def gaps(prog: dict, ref: dict) -> dict:
    """``{loss_gap, grad_gap, change_gap}`` of two readings."""
    lp, lr = prog["losses"], ref["losses"]
    if len(lp) != len(lr) or not _finite(*lp, *lr):
        loss = math.inf
    else:
        loss = max(abs(p - r) / abs(r) for p, r in zip(lp, lr))
    med = statistics.median(ref["grad_norms"].values())
    still = {k for k, g in ref["grad_norms"].items()
             if g < STILL_LEAF * med}
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
            "change_gap": leaf_gap(prog["change_norms"],
                                   ref["change_norms"], still)}


def judge(values: dict, limits: dict) -> bool:
    """Every compared number finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)
