"""The numbers that decide ``correct``, each the program's reading against
the reference's.

Training (the first ``checked_steps`` steps, from the same weights,
batches and H scores on both sides):

* ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the steps.
* ``grad1_gap``: the first step's clipped gradient as the optimizer got it
  (the program's: its AdamW ``mu`` after one step over 1 - b1), by the
  worst leaf: | |g| - |g_ref| | over the larger of |g_ref| and the median
  leaf's |g_ref|.
* ``change_gap``: the parameters' change over the steps, by the worst leaf
  in the same measure.
  ``grad1_median_gap`` and ``change_median_gap`` are the median leaf's.
* ``loss1_gap`` is ``loss_gap`` of the first step alone.

Leaves whose first reference gradient is under a thousandth of the median
leaf's are left out of both leaf measures: they move under Adam by
round-off alone.

A cell holds to a limit the numbers its ``bench/limits/<cell>.json`` names.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

SMALL_GRAD = 1e-3


def _norm(t) -> float:
    return float(t.double().norm())


def included_leaves(ref_grad1: Dict) -> List[str]:
    norms = {p: _norm(g) for p, g in ref_grad1.items()}
    med = statistics.median(norms.values())
    return sorted(p for p, n in norms.items() if n >= SMALL_GRAD * med)


def leaf_gap(prog: Dict, ref: Dict, leaves: List[str]) -> Tuple[float, str]:
    """Worst leaf of | |prog| - |ref| | / max(|ref|, median |ref|)."""
    norms = {p: _norm(ref[p]) for p in leaves}
    med = statistics.median(norms.values())
    worst = (0.0, "")
    for p in leaves:
        gap = abs(_norm(prog[p]) - norms[p]) / max(norms[p], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, p
        worst = max(worst, (gap, p))
    return worst


def train_numbers(prog: Dict, ref: Dict, weights_flat: Dict, b1: float) -> Dict:
    """``prog``: losses, mu1 (the optimizer's first moment after step 1)
    and params (after the steps), by path; ``ref``: ``run_steps``'s
    result."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
            for a, b in zip(prog["losses"], ref["losses"])]
    loss_gap = max(gaps) if len(prog["losses"]) == len(ref["losses"]) else math.inf
    leaves = included_leaves(ref["grad1"])
    g1 = {p: prog["mu1"][p] / (1.0 - b1) for p in leaves}
    grad1_gap, grad1_leaf = leaf_gap(g1, ref["grad1"], leaves)
    med_g = statistics.median(_norm(ref["grad1"][p]) for p in leaves)
    grad1_median_gap = statistics.median(
        abs(_norm(g1[p]) - _norm(ref["grad1"][p])) / max(_norm(ref["grad1"][p]), med_g, 1e-30)
        for p in leaves)
    d_prog = {p: prog["params"][p].double() - weights_flat[p].double() for p in prog["params"]}
    d_ref = {p: ref["params"][p].double() - weights_flat[p].double() for p in leaves}
    change_gap, change_leaf = leaf_gap(d_prog, d_ref, leaves)
    med_ref = statistics.median(_norm(d) for d in d_ref.values())
    change_median_gap = statistics.median(
        abs(_norm(d_prog[p]) - _norm(d_ref[p])) / max(_norm(d_ref[p]), med_ref, 1e-30)
        for p in leaves)
    return dict(loss_gap=loss_gap, loss1_gap=gaps[0], grad1_gap=grad1_gap,
                grad1_leaf=grad1_leaf, grad1_median_gap=grad1_median_gap,
                change_gap=change_gap, change_leaf=change_leaf,
                change_median_gap=change_median_gap, leaves=len(leaves),
                left_out=sorted(set(ref["grad1"]) - set(leaves)))


def checks(numbers: Dict, limits: Dict) -> Tuple[bool, List[Dict]]:
    """Each limited number beside its limit; correct when every one is
    finite and at most its limit."""
    rows = [dict(name=k, value=numbers[k], limit=limits[k]) for k in sorted(limits)]
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows)
    return ok, rows
