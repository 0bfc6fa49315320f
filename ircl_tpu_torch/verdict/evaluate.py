"""Verdict evaluation: per-class precision/recall/F1 + macro averages.

Counterpart of ``ircl_tpu/verdict/evaluate.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Replaces the reference's sklearn ``classification_report`` /
``f1_score(average='macro')`` usage (``src/QA/train.py:72-74``,
``src/QA/evaluate.py:83-88``) with a dependency-free implementation returning
a structured dict (and a printable table).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def classification_report(
    y_true: Sequence[int], y_pred: Sequence[int], labels=None
) -> Dict:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = sorted(set(y_true.tolist()) | set(y_pred.tolist()))

    per_class = {}
    f1s, ps, rs = [], [], []
    for lab in labels:
        tp = int(np.sum((y_pred == lab) & (y_true == lab)))
        fp = int(np.sum((y_pred == lab) & (y_true != lab)))
        fn = int(np.sum((y_pred != lab) & (y_true == lab)))
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        support = int(np.sum(y_true == lab))
        per_class[int(lab)] = {
            "precision": p,
            "recall": r,
            "f1": f1,
            "support": support,
        }
        ps.append(p)
        rs.append(r)
        f1s.append(f1)

    return {
        "per_class": per_class,
        "accuracy": float(np.mean(y_true == y_pred)) if len(y_true) else 0.0,
        "macro_precision": float(np.mean(ps)) if ps else 0.0,
        "macro_recall": float(np.mean(rs)) if rs else 0.0,
        "macro_f1": float(np.mean(f1s)) if f1s else 0.0,
    }


def format_report(report: Dict) -> str:
    lines = [f"{'label':>8} {'prec':>7} {'recall':>7} {'f1':>7} {'support':>8}"]
    for lab, m in report["per_class"].items():
        lines.append(
            f"{lab:>8} {m['precision']:>7.3f} {m['recall']:>7.3f} "
            f"{m['f1']:>7.3f} {m['support']:>8}"
        )
    lines.append(
        f"{'macro':>8} {report['macro_precision']:>7.3f} "
        f"{report['macro_recall']:>7.3f} {report['macro_f1']:>7.3f}"
    )
    lines.append(f"accuracy {report['accuracy']:.3f}")
    return "\n".join(lines)
