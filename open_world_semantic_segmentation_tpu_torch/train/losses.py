"""Loss functions of the training stacks, vectorised.

Counterpart of the JAX package's ``train/losses.py``: ``cross_entropy``,
``pixel_acc`` and ``dml_segmentation_loss`` (the reference's
``SegmentationModule`` loss, anomaly/models/models.py:34-84, without its
Python loop over images and classes), and the DeepLab stack's
``deeplab_cross_entropy``, ``focal_loss`` and ``distillation_loss``
(utils/loss.py). Reference semantics kept exactly:

- CE is a *mean* over valid pixels (labels != ``ignore_index``);
- VAR sums ``-logit[p, y_p]`` over the valid pixels of each image and
  divides by the image's FULL pixel count (ignore pixels included);
- Inter sums the other classes' logits the same way (beta = 0 as shipped);
- ``loss = ce / n + alpha * var / n + beta * inter / n`` over a batch of n.
- DeepLab: ``CE / n``, the reference's active path; its dead-code metric
  terms and the feature-distillation term behind flags.

Logits are (B, H, W, K) in the JAX package's layout; labels (B, H, W)
integers. The losses are taken in float32 for float32 or lower logits (the
JAX package takes them in the model dtype, bf16 in a bf16 run), and in
float64 for float64.
"""

from __future__ import annotations

import torch


def _at_least_float32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _gather_logit(logits: torch.Tensor, labels: torch.Tensor):
    """The logit at each pixel's label (labels clipped so that ignore
    values index safely; the caller masks them)."""
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    return logits.gather(-1, safe[..., None])[..., 0]


def cross_entropy(logits, labels, ignore_index: int = -1):
    """Mean cross entropy over valid pixels (torch CrossEntropyLoss
    parity)."""
    logits = _at_least_float32(logits)
    valid = labels != ignore_index
    nll = torch.logsumexp(logits, dim=-1) - _gather_logit(logits, labels)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def pixel_acc(logits, labels):
    """Accuracy over labels >= 0 (models.py:15-21)."""
    preds = logits.argmax(-1)
    valid = labels >= 0
    acc_sum = (valid & (preds == labels)).sum()
    return acc_sum.float() / (valid.sum().float() + 1e-10)


def dml_segmentation_loss(logits, labels, *, alpha: float = 0.01,
                          beta: float = 0.0, ignore_index: int = -1):
    """The SegmentationModule training loss. Returns
    ``(loss, (ce, var, inter, acc))``."""
    logits = _at_least_float32(logits)
    n = logits.shape[0]
    hw = logits.shape[1] * logits.shape[2]
    valid = labels != ignore_index

    ce = cross_entropy(logits, labels, ignore_index)
    picked = _gather_logit(logits, labels)
    var = (torch.where(valid, -picked, 0.0).sum((1, 2)) / hw).sum()
    total = logits.sum(-1)
    inter = (torch.where(valid, total - picked, 0.0).sum((1, 2)) / hw).sum()

    loss = ce / n + alpha * var / n + beta * inter / n
    return loss, (ce, var, inter, pixel_acc(logits, labels))


def deeplab_cross_entropy(logits, labels, features_in=None, *,
                          alpha: float = 0.0, beta: float = 0.0,
                          gamma: float = 0.0, ignore_index: int = 255,
                          use_metric_terms: bool = False, num_classes=None):
    """utils/loss.py:25-82. The active reference path is ``CE / n``.

    With ``use_metric_terms`` the reference's dead-code terms come in:
    ``(CE + alpha*VAR + beta*Inter + gamma*Center) / n``, VAR and Inter as
    in ``dml_segmentation_loss`` and Center the within-class spread of
    ``features_in`` (B, H, W, C): per image and class the mean embedding of
    the class's valid pixels, then the squared distance of each valid pixel
    to its class's mean, summed per image over its full pixel count.
    ``num_classes`` (default the logits' K) is the JAX package's one-hot
    width: a label at or above it counts in no class."""
    logits = _at_least_float32(logits)
    n = logits.shape[0]
    ce = cross_entropy(logits, labels, ignore_index)
    if not use_metric_terms:
        return ce / n

    hw = logits.shape[1] * logits.shape[2]
    valid = labels != ignore_index
    picked = _gather_logit(logits, labels)
    var = (torch.where(valid, -picked, 0.0).sum((1, 2)) / hw).sum()
    total = logits.sum(-1)
    inter = (torch.where(valid, total - picked, 0.0).sum((1, 2)) / hw).sum()

    center = 0.0
    if gamma and features_in is not None:
        f = _at_least_float32(features_in)
        b, c = f.shape[0], f.shape[-1]
        k = num_classes or logits.shape[-1]
        member = (valid & (labels >= 0) & (labels < k)).reshape(b, -1)
        idx = torch.where(member, labels.reshape(b, -1), 0).long()
        w = member.to(f.dtype)
        flat = f.reshape(b, -1, c)
        # class sums and counts as one-hot products, where a scatter_add_
        # adds with atomics on CUDA in an order that changes between runs
        onehot = torch.nn.functional.one_hot(idx, k).to(f.dtype)
        sums = (onehot * w[..., None]).transpose(1, 2) @ flat
        counts = (onehot * w[..., None]).sum(1)
        means = sums / counts.clamp(min=1.0)[..., None]
        own = onehot @ means            # each pixel's class mean, exactly
        center = ((((flat - own) ** 2).sum(-1) * w).sum(1) / hw).sum()

    return (ce + alpha * var + beta * inter + gamma * center) / n


def focal_loss(logits, labels, *, alpha: float = 1.0, gamma: float = 0.0,
               ignore_index: int = 255, size_average: bool = True):
    """utils/loss.py:7-23: ``alpha * (1 - pt)^gamma * CE`` per pixel, 0 at
    ignored pixels; the mean over ALL pixels (torch's
    ``F.cross_entropy(reduction='none').mean()``) or the sum."""
    logits = _at_least_float32(logits)
    valid = labels != ignore_index
    ce = torch.logsumexp(logits, dim=-1) - _gather_logit(logits, labels)
    ce = torch.where(valid, ce, 0.0)
    pt = torch.exp(-ce)
    fl = torch.where(valid, alpha * (1 - pt) ** gamma * ce, 0.0)
    return fl.mean() if size_average else fl.sum()


def distillation_loss(logits, labels, features_1, features_2, *,
                      ignore_index: int = 255, novel_class: int = 16,
                      use_distillation_term: bool = False,
                      dis_weight: float = 0.01):
    """utils/loss.py:84-122 (CrossEntropyLoss_dis). The active reference
    path is ``CE / n``. With ``use_distillation_term``, plus ``dis_weight``
    times, per image, the mean over its non-novel pixels of the squared
    distance between the student's features ``features_2`` and the
    teacher's ``features_1`` zero-padded by one channel (loss.py:106-107),
    summed over the batch and divided by n."""
    logits = _at_least_float32(logits)
    n = logits.shape[0]
    ce = cross_entropy(logits, labels, ignore_index)
    if not use_distillation_term:
        return ce / n

    f2 = _at_least_float32(features_2)
    f1 = torch.nn.functional.pad(features_1.to(f2.dtype), (0, 1))
    keep = (labels != novel_class)[..., None]
    diff = torch.where(keep, f2 - f1, 0.0)
    counts = keep.sum((1, 2, 3)).clamp(min=1)
    dis = ((diff ** 2).sum((1, 2, 3)) / counts.to(diff.dtype)).sum()
    return ce / n + dis_weight * dis / n
