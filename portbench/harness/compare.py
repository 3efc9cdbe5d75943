"""The numbers that decide `correct`, each a gap between what the timed
path produced and the plain reference.

Training, over the checked steps (norms per leaf, a gap of norms taken
against the larger of the leaf's reference norm and the median leaf's):

- `loss1_gap`: |first step's loss - the reference's| / the reference's;
- `grad_row_median_gap`: the first step's gradient as the optimizer got
  it, by rows (a convolution's or the fc's output channel, a batch-norm
  vector's element): the median over rows of the gap of their norms, each
  against the larger of its reference norm and the median row's;
- `change_median_gap`: the median over leaves of the weights' change gap,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
- `grad_leaf_worst`, `change_leaf_worst`: the worst leaf of the first
  gradient's and of the change's gaps (the change over the same leaves as
  its median), so that one leaf gone wrong by a large share fails however
  small it is.

Under the configuration's TF32 convolutions the first layers' leaves,
whose input (the MFCCs) carries a large offset that batch norm takes away,
read the worst gaps, as high as the bfloat16 control's on some seeds: the
control fails the row median, and the worst leaf is held only against a
state left unchanged, which reads 1. A gap of norms is the projection of
the error on the gradient, random in size from seed to seed; the median
over some thousands of rows is steady where one leaf is not (PERF.md gives
the readings). The later steps' losses are read and not compared
(`training_detail`).

Serving: per route, the largest |p - p_ref| over every probability of the
checked requests. A missing, misshapen or non-finite answer reads `MISSING`.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import torch

QUIET = 1e-3  # a leaf whose reference gradient is under this share of the median's
MISSING = 1e30  # the reading of a missing, misshapen or non-finite answer


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(mine: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """name -> |norm - reference norm| / max(reference norm, median
    reference norm), over the leaves in `keep` (all when None); every leaf
    reads `MISSING` where the two sides do not hold the same leaves or a
    norm is not finite."""
    keys = [k for k in ref if keep is None or k in keep]
    if set(mine) != set(ref):
        return {k: MISSING for k in keys} or {"": MISSING}
    a, b = _norms(mine), _norms(ref)
    median = statistics.median(b.values())
    return {k: abs(a[k] - b[k]) / max(b[k], median, 1e-30) if math.isfinite(a[k]) else MISSING
            for k in keys}


def _rows(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf cut into its rows: the slices along the first axis (an
    output channel; one element of a vector)."""
    return {f"{k}[{i}]": row for k, v in d.items() for i, row in enumerate(v.unbind(0))}


def _rel(a: float, b: float) -> float:
    gap = abs(a - b) / max(abs(b), 1e-30)
    return gap if math.isfinite(gap) else MISSING


def _moving(ref: dict) -> set:
    gref = _norms(ref["first_grad"])
    median = statistics.median(gref.values())
    return {k for k, v in gref.items() if v >= QUIET * median}


def training(losses: Sequence[float], first_grad, change, ref: dict) -> Dict[str, float]:
    loss1 = _rel(losses[0], ref["losses"][0]) if losses else MISSING
    grad = leaf_gaps(first_grad, ref["first_grad"])
    chg = leaf_gaps(change, ref["change"], _moving(ref))
    return {
        "loss1_gap": loss1,
        "grad_row_median_gap": statistics.median(
            leaf_gaps(_rows(first_grad), _rows(ref["first_grad"])).values()),
        "change_median_gap": statistics.median(chg.values()),
        "grad_leaf_worst": max(grad.values()),
        "change_leaf_worst": max(chg.values()),
    }


def training_detail(losses: Sequence[float], first_grad, change, ref: dict) -> dict:
    """Each step's loss gap and every leaf's gaps."""
    return {"loss_gaps": [_rel(a, b) for a, b in zip(losses, ref["losses"])],
            "grad_leaves": leaf_gaps(first_grad, ref["first_grad"]),
            "change_leaves": leaf_gaps(change, ref["change"], _moving(ref))}


def prob_gap(probs: Sequence[torch.Tensor], refs: Sequence[torch.Tensor]) -> float:
    """The largest |p - p_ref| over a route's checked requests."""
    if not probs:
        return MISSING
    worst = 0.0
    for p, q in zip(probs, refs):
        if p is None or tuple(p.shape) != tuple(q.shape):
            return MISSING
        gap = float((p.double() - q.double().to(p.device)).abs().max())
        if not math.isfinite(gap):
            return MISSING
        worst = max(worst, gap)
    return worst
