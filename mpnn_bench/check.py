"""The comparison that decides ``correct``: the program's outputs against
the plain reference's. The readings of a run are below; the ones that a
cell's ``limits/<workload>.json`` gives a limit are compared, each
against it (limits set from the readings recorded there), and the others
are kept beside them.

Training (the steps of the check's calls, which the program ran through
its K-step graph from the benchmark's weights, on batches that all
differ):

* ``loss_gap``: the first step's |loss - reference| / |reference|;
  ``loss_gap_worst_step``: the largest over the steps;
* ``change_gap``: the median over the leaves of each leaf's gap between
  the norms of its change over the steps and the reference's, over that
  leaf's reference norm or the median leaf's, whichever is larger,
  leaving out the leaves whose first reference gradient is under a
  thousandth of the median leaf's (nought to rounding; they move under
  Adam by round-off alone); ``change_gap_worst_leaf``: the largest such
  gap; ``change_gap_bond``: the largest over the bond table and the bond
  transforms, the leaves whose gradient the ``dK`` kernel computes.

Screening (every sweep of the window against the reference's sweep):

* ``top_gap``: the larger of the largest |prediction - reference| over
  the candidates the program returned, and the largest gap between the
  k-th of the reference's values of those candidates, sorted, and the
  k-th lowest of the whole grid (0 when the program returned the true
  top k up to exact ties): a wrong value and a wrong candidate both read
  here, in log10 eta.

A number that cannot be read (a missing or non-finite output) reads
infinity, and fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

ZERO_GRAD = 1e-3  # of the median leaf's first gradient: a leaf nought to rounding


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep: Sequence[str]):
    floor = statistics.median(want[k] for k in keep)
    return [abs(got[k] - want[k]) / max(want[k], floor) for k in keep]


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def train_numbers(prog: Dict, ref: Dict, p0: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """``prog``/``ref``: ``losses`` (one a step) and ``p`` (name -> tensor
    after the steps); ``ref`` also ``g1``, its first clipped gradient.
    Returns the readings and the lists kept beside them."""
    names = list(p0)
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not steps:
        steps = [math.inf]
    g_ref = {k: _norm(ref["g1"][k]) for k in names}
    med = statistics.median(g_ref.values())
    keep = [k for k in names if g_ref[k] >= ZERO_GRAD * med]
    d_ref = {k: _norm(ref["p"][k] - p0[k]) for k in keep}
    d_prog = {k: _norm(prog["p"][k] - p0[k]) for k in keep}
    change = dict(zip(keep, _leaf_gaps(d_prog, d_ref, keep)))
    bond = [v for k, v in change.items() if k.endswith(("bond_embed", "bond_transform"))]
    numbers = {"loss_gap": _finite(steps[0]), "loss_gap_worst_step": _finite(max(steps)),
               "change_gap": _finite(statistics.median(change.values())),
               "change_gap_worst_leaf": _finite(max(change.values())),
               "change_gap_bond": _finite(max(bond)) if bond else math.inf}
    read = {"step_loss_gaps": steps, "left_out_of_change_gap": [k for k in names if k not in keep]}
    return numbers, read


def screen_numbers(sweeps: List[List[Tuple[int, float]]], ref_values: torch.Tensor,
                   k: int) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``sweeps``: each sweep's returned candidates as ``(gid, prediction)``
    (``gid`` -1 for a candidate not on the grid); ``ref_values``: the
    reference's grid of values. Returns ``top_gap`` and its two parts."""
    flat = ref_values.reshape(-1).double().cpu()
    top = torch.sort(flat, stable=True).values[:k]
    pred_gap = rank_gap = 0.0
    bad = not sweeps
    for res in sweeps:
        if len(res) != k or any(g < 0 for g, _ in res):
            bad = True
            break
        gids = torch.tensor([g for g, _ in res])
        got = torch.tensor([v for _, v in res], dtype=torch.float64)
        want = flat[gids]
        pred_gap = max(pred_gap, float((got - want).abs().max()))
        rank_gap = max(rank_gap, float((torch.sort(want).values - top).abs().max()))
    gap = max(pred_gap, rank_gap)
    if bad or not math.isfinite(gap):
        return {"top_gap": math.inf}, {"pred_gap": math.inf, "rank_gap": math.inf}
    return {"top_gap": gap}, {"pred_gap": pred_gap, "rank_gap": rank_gap}


def judge(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, Dict[str, Dict]]:
    """Every number that ``limits`` names within its limit (one that was
    not read reads infinity); the checks as the result line and standard
    error give them, number beside limit."""
    checks = {}
    for name, lim in limits["numbers"].items():
        value = _finite(float(numbers.get(name, math.inf)))
        checks[name] = {"value": value, "limit": float(lim["limit"])}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
