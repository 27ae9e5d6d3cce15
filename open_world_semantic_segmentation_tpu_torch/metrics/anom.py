"""Anomaly (OOD) detection metrics: AUROC, AUPR, FPR@recall.

Numerically-exact re-derivation of the reference metric surface
(``anomaly/anom_utils.py:7-116`` in the reference repo) without a sklearn
dependency: AUROC and AUPR are computed from the same sorted-threshold sweep
sklearn uses internally (descending mergesort, distinct-score thresholds,
trapezoid / step-sum integration), so results agree with
``sklearn.metrics.roc_auc_score`` / ``average_precision_score`` to float64
rounding. ``fpr_and_fdr_at_recall`` reproduces the reference's custom sweep
bit-for-bit (including its argmin tie-breaking on ``|recall - level|``).

All functions are host-side numpy: they run on 1e6-element score vectors once
per image, where sorting dominates — not a TPU-shaped workload. The score
*maps* that feed them are produced on-device (see ``openset.scoring``).
"""

from __future__ import annotations

import numpy as np

RECALL_LEVEL_DEFAULT = 0.95


def stable_cumsum(arr, rtol=1e-05, atol=1e-08):
    """float64 cumsum that verifies the total against a direct sum.

    Parity: anomaly/anom_utils.py:7-23.
    """
    out = np.cumsum(arr, dtype=np.float64)
    expected = np.sum(arr, dtype=np.float64)
    if not np.allclose(out[-1], expected, rtol=rtol, atol=atol):
        raise RuntimeError(
            "cumsum was found to be unstable: "
            "its last element does not correspond to sum"
        )
    return out


def _validate_binary(y_true, pos_label):
    classes = np.unique(y_true)
    if pos_label is None and not (
        np.array_equal(classes, [0, 1])
        or np.array_equal(classes, [-1, 1])
        or np.array_equal(classes, [0])
        or np.array_equal(classes, [-1])
        or np.array_equal(classes, [1])
    ):
        raise ValueError("Data is not binary and pos_label is not specified")
    if pos_label is None:
        pos_label = 1.0
    return pos_label


def _threshold_sweep(y_true, y_score, pos_label=None):
    """Shared descending-score threshold sweep.

    Returns (tps, fps) cumulative counts at each *distinct* score threshold,
    matching sklearn's ``_binary_clf_curve``: stable mergesort descending,
    thresholds at the last index of each tied score block.
    """
    pos_label = _validate_binary(y_true, pos_label)
    y_true = y_true == pos_label

    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]

    distinct_idx = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct_idx, y_true.size - 1]

    tps = stable_cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return tps, fps, y_score[threshold_idxs]


def binary_auroc(y_true, y_score, pos_label=None):
    """Area under the ROC curve via trapezoid rule on the full curve.

    Agrees with ``sklearn.metrics.roc_auc_score`` (binary) — collinear-point
    dropping in sklearn's roc_curve does not change the trapezoid area.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, dtype=np.float64)
    tps, fps, _ = _threshold_sweep(y_true, y_score, pos_label)
    # prepend the (0, 0) origin
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    if tps[-1] <= 0 or fps[-1] <= 0:
        raise ValueError("Only one class present in y_true; AUROC undefined")
    tpr = tps / tps[-1]
    fpr = fps / fps[-1]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(tpr, fpr))


def binary_aupr(y_true, y_score, pos_label=None):
    """Average precision (step-wise area under precision-recall curve).

    Agrees with ``sklearn.metrics.average_precision_score``:
    AP = sum_n (R_n - R_{n-1}) * P_n over descending thresholds.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, dtype=np.float64)
    tps, fps, _ = _threshold_sweep(y_true, y_score, pos_label)
    if tps[-1] == 0:
        # sklearn warns and returns 0-recall curve; AP = 0 with no positives
        return 0.0
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1]
    # step integral: AP = sum (recall_i - recall_{i-1}) * precision_i
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def fpr_and_fdr_at_recall(y_true, y_score,
                          recall_level=RECALL_LEVEL_DEFAULT, pos_label=None):
    """FPR at the threshold where recall first reaches ``recall_level``.

    Bit-parity port of anomaly/anom_utils.py:25-65, including the reversed
    slice from the first full-recall index and argmin tie handling.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, dtype=np.float64)
    pos_label = _validate_binary(y_true, pos_label)
    y_true = y_true == pos_label

    tps, fps, thresholds = _threshold_sweep(y_true, y_score, pos_label=True)

    recall = tps / tps[-1]

    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    recall = np.r_[recall[sl], 1]
    fps_r = np.r_[fps[sl], 0]

    cutoff = np.argmin(np.abs(recall - recall_level))
    return float(fps_r[cutoff] / np.sum(np.logical_not(y_true)))


def get_measures(_pos, _neg, recall_level=RECALL_LEVEL_DEFAULT):
    """(auroc, aupr, fpr@recall) for positive vs negative score samples.

    Parity: anomaly/anom_utils.py:67-78 — positives are labeled 1 and listed
    first, metric order is (auroc, aupr, fpr).
    """
    pos = np.array(_pos[:]).reshape((-1, 1))
    neg = np.array(_neg[:]).reshape((-1, 1))
    examples = np.squeeze(np.vstack((pos, neg)))
    labels = np.zeros(len(examples), dtype=np.int32)
    labels[: len(pos)] += 1

    auroc = binary_auroc(labels, examples)
    aupr = binary_aupr(labels, examples)
    fpr = fpr_and_fdr_at_recall(labels, examples, recall_level)
    return auroc, aupr, fpr


def get_and_print_results(out_score, in_score, num_to_avg=1):
    """Parity: anomaly/anom_utils.py:95-104 (the averaging loop is vestigial)."""
    measures = get_measures(out_score, in_score)
    return measures


def eval_ood_measure(conf, seg_label, out_labels=(13,), mask=None):
    """Per-image OOD measure from a confidence map and label map.

    Parity: anomaly/eval_ood_traditional.py:128-148. ``conf`` is negated so
    that more-anomalous = higher score; pixels whose label is in
    ``out_labels`` are the positive (anomalous) class.

    Returns (auroc, aupr, fpr) or None when the image is single-class.
    """
    conf = np.asarray(conf)
    seg_label = np.asarray(seg_label)
    if mask is not None:
        seg_label = seg_label[mask]
        conf = conf[mask]

    out_label = seg_label == out_labels[0]
    for label in out_labels:
        out_label = np.logical_or(out_label, seg_label == label)

    in_scores = -conf[np.logical_not(out_label)]
    out_scores = -conf[out_label]

    if (len(out_scores) != 0) and (len(in_scores) != 0):
        return get_and_print_results(out_scores, in_scores)
    return None


def print_measures(auroc, aupr, fpr, method_name="Ours",
                   recall_level=RECALL_LEVEL_DEFAULT):
    """Parity: anomaly/anom_utils.py:81-86."""
    print("\t\t\t\t" + method_name)
    print("FPR{:d}:\t\t\t{:.2f}".format(int(100 * recall_level), 100 * fpr))
    print("AUROC: \t\t\t{:.2f}".format(100 * auroc))
    print("AUPR:  \t\t\t{:.2f}".format(100 * aupr))
