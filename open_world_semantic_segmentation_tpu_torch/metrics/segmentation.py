"""Segmentation quality metrics: pixel accuracy, histogram IoU, streaming
mIoU.

- ``pixel_accuracy`` and ``intersection_and_union`` mirror the reference's
  ``anomaly/utils.py:128-156`` in numpy (labels >= 0 are valid; the IoU
  histogram shifts labels by +1 and zeroes predictions on unlabeled
  pixels, label -1). ``intersection_and_union_torch`` computes the same
  histograms on the device, so the eval loop moves K counts to the host
  instead of a label map.
- ``StreamSegMetrics`` mirrors the reference's DeepLab
  ``metrics/stream_metrics.py`` as it runs: its ``__init__`` hard-codes 19
  classes and every CLI calls ``reset()`` first, so the confusion matrix
  is 19x19 whatever the constructor is given; labels >= 19 (the 255 ignore
  id) fall outside its mask, and rows of absent classes give NaN IoUs that
  ``nanmean`` skips. ``hist_classes=19`` keeps that, as in the JAX package.
  ``confusion_matrix_update`` adds one batch's counts on the device, for
  ``update_hist``.
"""

from __future__ import annotations

import numpy as np
import torch


def pixel_accuracy(preds, label):
    """(accuracy, n_valid) over labels >= 0."""
    preds = np.asarray(preds)
    label = np.asarray(label)
    valid = label >= 0
    acc_sum = (valid * (preds == label)).sum()
    valid_sum = valid.sum()
    acc = float(acc_sum) / (valid_sum + 1e-10)
    return acc, valid_sum


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


def confusion_matrix_update(hist: torch.Tensor, label_true: torch.Tensor,
                            label_pred: torch.Tensor, n_classes: int):
    """``hist`` plus the (n_classes, n_classes) confusion counts of one
    batch, on hist's device, with no host synchronisation: only pixels
    with 0 <= label < n_classes count; predictions (clipped to the
    classes) index the columns."""
    lt = label_true.reshape(-1).long()
    lp = label_pred.reshape(-1).long()
    mask = (lt >= 0) & (lt < n_classes)
    idx = torch.where(mask, n_classes * lt + lp.clamp(0, n_classes - 1), 0)
    counts = torch.zeros(n_classes * n_classes, dtype=hist.dtype,
                         device=hist.device).scatter_add_(
        0, idx, mask.to(hist.dtype))
    return hist + counts.reshape(n_classes, n_classes)


class StreamSegMetrics:
    """Streaming confusion-matrix segmentation metrics (numpy, on the
    host).

    ``hist_classes`` defaults to 19, the reference's hard-coded count (see
    the module note); beyond 19 classes the true count is used, since the
    reference's 19x19 reshape would fail there.
    """

    def __init__(self, n_classes: int, hist_classes: int = 19):
        self.n_classes = max(n_classes, hist_classes)
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))

    def update(self, label_trues, label_preds):
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += self._fast_hist(lt.flatten(),
                                                     lp.flatten())

    def update_hist(self, hist):
        """Merge a confusion matrix computed on the device
        (``confusion_matrix_update``)."""
        self.confusion_matrix += np.asarray(hist)

    @staticmethod
    def to_str(results):
        string = "\n"
        for k, v in results.items():
            if k != "Class IoU":
                string += "%s: %f\n" % (k, v)
        return string

    def _fast_hist(self, label_true, label_pred):
        mask = (label_true >= 0) & (label_true < self.n_classes)
        return np.bincount(
            self.n_classes * label_true[mask].astype(int) + label_pred[mask],
            minlength=self.n_classes ** 2,
        ).reshape(self.n_classes, self.n_classes)

    def get_results(self, verbose: bool = False):
        import warnings

        hist = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"), \
                warnings.catch_warnings():
            # nanmean of an all-NaN row warns through the warnings module;
            # NaN is the reference's result there
            warnings.filterwarnings("ignore", "Mean of empty slice",
                                    RuntimeWarning)
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iu = np.diag(hist) / (
                hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
            mean_iu = np.nanmean(iu)
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        if verbose:
            print(iu)
        cls_iu = dict(zip(range(self.n_classes), iu))
        return {
            "Overall Acc": acc,
            "Mean Acc": acc_cls,
            "FreqW Acc": fwavacc,
            "Mean IoU": mean_iu,
            "Class IoU": cls_iu,
        }

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))
