"""Loss functions of the anomaly stack's training, vectorised.

Counterpart of the JAX package's ``train/losses.py`` (``cross_entropy``,
``pixel_acc``, ``dml_segmentation_loss``), itself the reference's
``SegmentationModule`` loss (anomaly/models/models.py:34-84) without its
Python loop over images and classes. Reference semantics kept exactly:

- CE is a *mean* over valid pixels (labels != ``ignore_index``);
- VAR sums ``-logit[p, y_p]`` over the valid pixels of each image and
  divides by the image's FULL pixel count (ignore pixels included);
- Inter sums the other classes' logits the same way (beta = 0 as shipped);
- ``loss = ce / n + alpha * var / n + beta * inter / n`` over a batch of n.

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
