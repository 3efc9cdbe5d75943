"""Host-side metric battery in numpy (counterpart of
tcresnet_tpu/metrics/host_metrics.py:18-99).

The JAX package computes these with scikit-learn, which the machine with
the card does not have; this module computes the same numbers with numpy
alone and is held to scikit-learn on the CPU (tests/test_torch_eval.py):

- `top_k_accuracy`, with ties broken toward the lowest class index;
- accuracy;
- mAP_{macro,micro,weighted,samples}: scikit-learn's
  `average_precision_score` on the one-hot labels, the step integral
  sum_n (R_n - R_(n+1)) P_n of the precision-recall curve over distinct
  score thresholds. A class with no positive example scores 0.0 (its
  recall is taken as 1 at every threshold, as scikit-learn does); the
  "weighted" average gives it weight 0;
- per-class precision / recall / F1 / AP with zero_division=0;
- a classification report as text (the port's own layout).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def top_k_accuracy(scores: np.ndarray, labels: np.ndarray, k: int = 5) -> float:
    """Share of rows whose label is among the k highest scores; ties go to
    the lowest class index (a stable sort of the negated scores), and k is
    clamped to the class count."""
    k = min(k, scores.shape[1])
    topk = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return float(np.mean(np.any(topk == labels[:, None], axis=1)))


def binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision of one binary column (scikit-learn's
    uninterpolated step integral, thresholds at the distinct scores)."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    score = y_score[order]
    truth = np.asarray(y_true, np.float64)[order]
    last = np.r_[np.nonzero(np.diff(score))[0], truth.size - 1]
    tps = np.cumsum(truth)[last]
    fps = 1.0 + last - tps
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def mean_average_precision(onehot: np.ndarray, scores: np.ndarray, average: str) -> float:
    """`average_precision_score(onehot, scores, average=...)`."""
    if average == "micro":
        return binary_average_precision(onehot.ravel(), scores.ravel())
    if average == "samples":
        # per row, the step integral in closed form: the mean over its
        # positives p of (positives scoring >= s_p) / (all scoring >= s_p),
        # ties grouped as scikit-learn groups them; 0 without positives
        positive = onehot > 0
        at_least = scores[:, None, :] >= scores[:, :, None]  # [N, p, j]: s_j >= s_p
        ratio = (at_least & positive[:, None, :]).sum(-1) / at_least.sum(-1)
        per_row = np.where(positive, ratio, 0.0).sum(-1) / np.maximum(positive.sum(-1), 1)
        return float(np.mean(per_row))
    per_class = np.array([binary_average_precision(onehot[:, c], scores[:, c])
                          for c in range(onehot.shape[1])])
    if average == "macro":
        return float(np.mean(per_class))
    if average == "weighted":
        weight = onehot.sum(axis=0)
        if np.isclose(weight.sum(), 0.0):
            return 0.0
        per_class[weight == 0] = 0.0
        return float(np.average(per_class, weights=weight))
    raise ValueError(f"unknown average {average!r}")


def precision_recall_f1(labels: np.ndarray, preds: np.ndarray, num_classes: int):
    """Per-class (precision, recall, f1, support), zero_division=0."""
    classes = np.arange(num_classes)
    tp = np.array([np.sum((preds == c) & (labels == c)) for c in classes], np.float64)
    predicted = np.array([np.sum(preds == c) for c in classes], np.float64)
    support = np.array([np.sum(labels == c) for c in classes], np.float64)

    def ratio(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b != 0)

    f1 = ratio(2 * tp, predicted + support)
    return ratio(tp, predicted), ratio(tp, support), f1, support


def classification_report(labels: np.ndarray, preds: np.ndarray,
                          names: Optional[Sequence[str]], num_classes: int) -> str:
    """Per-class precision / recall / F1 / support over the classes present
    in labels or predictions, then accuracy and the macro and weighted
    averages over those classes."""
    present = sorted(set(labels.tolist()) | set(preds.tolist()))
    p, r, f1, support = precision_recall_f1(labels, preds, num_classes)
    names = [names[i] if names else str(i) for i in present]
    width = max([len(n) for n in names] + [len("weighted avg")])
    lines = [f"{'':>{width}} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}", ""]
    for name, c in zip(names, present):
        lines.append(f"{name:>{width}} {p[c]:>9.2f} {r[c]:>9.2f} {f1[c]:>9.2f} {int(support[c]):>9}")
    n = int(support[present].sum())
    lines += ["", f"{'accuracy':>{width}} {'':>9} {'':>9} "
                  f"{float(np.mean(labels == preds)):>9.2f} {n:>9}"]
    for label, weights in (("macro avg", None), ("weighted avg", support[present])):
        avg = [np.average(m[present], weights=weights) for m in (p, r, f1)]
        lines.append(f"{label:>{width}} " + " ".join(f"{v:>9.2f}" for v in avg) + f" {n:>9}")
    return "\n".join(lines) + "\n"


def compute_classification_metrics(
    scores: np.ndarray,
    labels: np.ndarray,
    label_names: Optional[Sequence[str]] = None,
    use_class_metrics: bool = False,
    include_report: bool = False,
) -> Dict[str, float]:
    """The metric battery from softmax scores [N, C] and integer labels [N]:
    accuracy, top5_accuracy, mAP_{macro,micro,weighted,samples}; with
    `use_class_metrics` per-class precision / recall / f1 / AP under
    "<metric>/<name>"; with `include_report` the text report under
    "classification_report"."""
    num_classes = scores.shape[1]
    preds = scores.argmax(axis=1)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    out: Dict[str, float] = {
        "accuracy": float(np.mean(preds == labels)),
        "top5_accuracy": top_k_accuracy(scores, labels, 5),
    }
    for average in ("macro", "micro", "weighted", "samples"):
        out[f"mAP_{average}"] = mean_average_precision(onehot, scores, average)
    if use_class_metrics:
        names = list(label_names) if label_names else [str(i) for i in range(num_classes)]
        p, r, f1, _ = precision_recall_f1(labels, preds, num_classes)
        for i, name in enumerate(names):
            out[f"precision/{name}"] = float(p[i])
            out[f"recall/{name}"] = float(r[i])
            out[f"f1/{name}"] = float(f1[i])
            out[f"AP/{name}"] = binary_average_precision(onehot[:, i], scores[:, i])
    if include_report:
        out["classification_report"] = classification_report(
            labels, preds, list(label_names) if label_names else None, num_classes)
    return out
