"""Segmentation quality metrics: histogram IoU.

``intersection_and_union`` mirrors the reference's ``anomaly/utils.py:136-156``
in numpy (the IoU histogram shifts labels by +1 and zeroes predictions on
unlabeled pixels, label -1).
``intersection_and_union_torch`` computes the same histograms on the device,
so the eval loop moves K counts to the host instead of a label map.
"""

from __future__ import annotations

import numpy as np
import torch


def intersection_and_union(im_pred, im_lab, num_class):
    """Histogram intersection/union (numpy)."""
    im_pred = np.asarray(im_pred).copy()
    im_lab = np.asarray(im_lab).copy()

    im_pred += 1
    im_lab += 1
    # unlabeled pixels (label 0 after shift) do not penalize predictions
    im_pred = im_pred * (im_lab > 0)

    intersection = im_pred * (im_pred == im_lab)
    area_intersection, _ = np.histogram(
        intersection, bins=num_class, range=(1, num_class))
    area_pred, _ = np.histogram(im_pred, bins=num_class, range=(1, num_class))
    area_lab, _ = np.histogram(im_lab, bins=num_class, range=(1, num_class))
    area_union = area_pred + area_lab - area_intersection
    return area_intersection, area_union


def intersection_and_union_torch(im_pred: torch.Tensor,
                                 im_lab: torch.Tensor, num_class: int):
    """Device version of :func:`intersection_and_union`: (K,) int64
    intersection and union counts.

    ``np.histogram(bins=K, range=(1, K))`` has K equal bins over [1, K],
    the last one closed, and drops values outside the range; the same float
    edges and ``searchsorted`` reproduce its bucketing exactly.
    """
    im_pred = im_pred.long() + 1
    im_lab = im_lab.long() + 1
    im_pred = im_pred * (im_lab > 0)
    intersection = im_pred * (im_pred == im_lab)
    edges = torch.linspace(1.0, float(num_class), num_class + 1,
                           device=im_pred.device)

    def hist(v):
        v = v.reshape(-1).float()
        idx = torch.searchsorted(edges, v, right=True) - 1
        idx = torch.where(v == num_class, num_class - 1, idx)
        ok = (v >= 1.0) & (v <= num_class)
        idx = torch.where(ok, idx, 0)
        return torch.zeros(num_class, dtype=torch.int64,
                           device=v.device).scatter_add_(0, idx, ok.long())

    area_intersection = hist(intersection)
    area_pred = hist(im_pred)
    area_lab = hist(im_lab)
    return area_intersection, area_pred + area_lab - area_intersection
