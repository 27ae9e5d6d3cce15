"""Device-side OOD metrics: AUROC / AUPR / FPR@recall without the host.

Counterpart of the JAX package's ``metrics/anom_device.py``. The host path
(``metrics.anom``, float64, sklearn's threshold sweep) sorts ~1e6 scores
per image on the CPU; this module computes the same three numbers on the
tensor's device, so only four scalars per image reach the host.

Same formulation as the JAX module, in float32:

- the threshold sweep (distinct-score thresholds = tie-block ends) is the
  host's descending sort plus a boundary mask; "value at the previous
  threshold" is a cummax of boundary-masked monotone series;
- AUROC is the tie-averaged-rank (Mann-Whitney) identity, equal to the
  grouped trapezoid of the ROC curve;
- AUPR is the boundary-masked step sum AP = sum_k (R_k - R_{k-1}) P_k;
- FPR@recall follows ``anom_utils.py:25-65`` with its reversed-slice
  argmin tie-breaking (the largest threshold index wins ties; the appended
  (recall 1, fps 0) endpoint loses them).

Counts are exact in float32 up to 2^24 pixels (a 720x1280 image has
9.2e5); the AUROC numerator is a difference of ~1e10-scale sums, ~1e-6
relative. The host path stays the oracle; tests hold this one to 1e-5.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

RECALL_LEVEL_DEFAULT = 0.95


def _shift_right(x: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.cat([x.new_full((1,), fill), x[:-1]])


@torch.no_grad()
def ood_measures_from_maps(conf: torch.Tensor, seg_label: torch.Tensor,
                           out_labels: Sequence[int] = (13,),
                           recall_level: float = RECALL_LEVEL_DEFAULT):
    """(auroc, aupr, fpr, valid) as 0-d tensors on ``conf``'s device.

    Mirrors ``metrics.anom.eval_ood_measure``: score = -conf, positives
    are pixels whose label is in ``out_labels``, all pixels take part.
    ``valid`` is False when the image is single-class (the host path
    returns None there); the three metrics are then zero and must be
    ignored.
    """
    score = -conf.reshape(-1).float()
    lab = seg_label.reshape(-1).to(score.device)
    y = torch.zeros(lab.shape, dtype=torch.bool, device=score.device)
    for out in out_labels:
        y = y | (lab == out)
    n = score.shape[0]

    # descending as the host takes it: the host lists the anomalous pixels
    # first (get_measures), sorts stably ascending and reverses
    # (mergesort()[::-1]). Inside a tie block of equal scores the order
    # does not matter, but NaN scores (a 0/0 min-max normalised map) sort
    # last ascending, so they come first, each its own threshold (NaN !=
    # NaN), in the host's order. The JAX module's argsort(-score) parts
    # from the host there.
    first = torch.argsort((~y).to(torch.uint8), stable=True)
    score, y = score[first], y[first]
    order = torch.flip(torch.argsort(score, stable=True), (0,))
    s = score[order]
    t = y[order].float()

    tp = torch.cumsum(t, 0)
    idx = torch.arange(n, dtype=torch.float32, device=score.device)
    fp = (idx + 1.0) - tp
    # tie-block ends == sklearn's distinct-score threshold positions
    b = torch.cat([s[:-1] != s[1:],
                   torch.ones((1,), dtype=torch.bool, device=s.device)])

    p_total = tp[-1]
    n_neg = float(n) - p_total
    valid = (p_total > 0) & (n_neg > 0)
    p_safe = torch.clamp(p_total, min=1.0)
    n_safe = torch.clamp(n_neg, min=1.0)

    # ---- AUROC: tie-averaged ascending ranks (Mann-Whitney U)
    # block start a_i / end e_i in descending-position space
    prev_b = _shift_right(
        torch.cummax(torch.where(b, idx, -1.0), 0).values, -1.0)
    a = prev_b + 1.0
    e = torch.flip(torch.cummin(
        torch.flip(torch.where(b, idx, float(n)), (0,)), 0).values, (0,))
    # the ascending rank of descending position i is n - i; block average
    avg_rank = float(n) - 0.5 * (a + e)
    u_sum = torch.sum(avg_rank * t)
    auroc = (u_sum - 0.5 * p_safe * (p_safe + 1.0)) / (p_safe * n_safe)

    # ---- AUPR: step sum over threshold points
    prev_tp = _shift_right(
        torch.cummax(torch.where(b, tp, 0.0), 0).values, 0.0)
    precision = tp / (tp + fp)
    aupr = torch.sum(torch.where(b, (tp - prev_tp) * precision, 0.0)) / p_safe

    # ---- FPR@recall (anom_utils.py:25-65)
    # first boundary position with full recall (tps.searchsorted(tps[-1]))
    full = b & (tp >= p_total)
    p_star = torch.min(torch.where(full, idx, float(n)))
    cand = b & (idx <= p_star)
    d = torch.where(cand, torch.abs(tp / p_safe - recall_level),
                    float("inf"))
    d_min = torch.min(d)
    # the appended (recall 1, fps 0) endpoint, its distance in the same
    # float32 arithmetic as the candidates, so that full recall reached at
    # a threshold resolves its tie as the host's float64 path does
    d_virtual = float(abs(np.float32(1.0) - np.float32(recall_level)))
    # the reversed-array argmin scans down from last_ind, so the LARGEST
    # threshold index wins ties; the endpoint, scanned last, loses them
    best_pos = torch.max(torch.where(d == d_min, idx, -1.0))
    fps_best = torch.sum(torch.where(idx == best_pos, fp, 0.0))
    fpr = torch.where(d_min <= d_virtual, fps_best, 0.0) / n_safe

    zero = torch.zeros((), device=score.device)
    return (torch.where(valid, auroc, zero), torch.where(valid, aupr, zero),
            torch.where(valid, fpr, zero), valid)
