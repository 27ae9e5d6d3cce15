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

``group``: the ranks of a data-parallel step, each holding its share of
the global batch. Every sum and count (the valid pixels, the batch size n,
VAR, Inter, the center and distillation terms, the accuracy's counts) is
summed over them first, in one all-reduce that carries the gradient
(``parallel/mesh.py all_reduce_sum``), so each rank's loss is the loss of
the global batch, as under the JAX package's pjit; ranks may hold
different numbers of ignored pixels.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_sum


def _at_least_float32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _gather_logit(logits: torch.Tensor, labels: torch.Tensor):
    """The logit at each pixel's label (labels clipped so that ignore
    values index safely; the caller masks them)."""
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    return logits.gather(-1, safe[..., None])[..., 0]


def _sum_over(group, *values):
    """``values`` (0-d tensors, the first a float one, or numbers) summed
    over ``group``'s ranks in one all-reduce, in the first one's dtype;
    ``values`` as they are without a group."""
    if group is None:
        return values
    first = values[0]
    stacked = torch.stack([torch.as_tensor(v, dtype=first.dtype,
                                           device=first.device)
                           for v in values])
    return all_reduce_sum(stacked, group).unbind(0)


def _nll_sum(logits, labels, ignore_index):
    """(the summed negative log-likelihood of the valid pixels, their
    count)."""
    valid = labels != ignore_index
    nll = torch.logsumexp(logits, dim=-1) - _gather_logit(logits, labels)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum(), valid.sum()


def cross_entropy(logits, labels, ignore_index: int = -1, group=None):
    """Mean cross entropy over valid pixels (torch CrossEntropyLoss
    parity), over the global batch with a ``group``."""
    logits = _at_least_float32(logits)
    nll, count = _sum_over(group, *_nll_sum(logits, labels, ignore_index))
    return nll / count.clamp(min=1)


def pixel_acc(logits, labels, group=None):
    """Accuracy over labels >= 0 (models.py:15-21), over the global batch
    with a ``group``."""
    preds = logits.argmax(-1)
    valid = labels >= 0
    acc_sum, count = _sum_over(group, (valid & (preds == labels)).sum()
                               .float(), valid.sum().float())
    return acc_sum / (count + 1e-10)


def _var_inter(logits, labels, valid):
    """VAR and Inter: per image the sums over its valid pixels of
    ``-logit[y]`` and of the other logits, each over the image's full pixel
    count, summed over the batch."""
    hw = logits.shape[1] * logits.shape[2]
    picked = _gather_logit(logits, labels)
    var = (torch.where(valid, -picked, 0.0).sum((1, 2)) / hw).sum()
    total = logits.sum(-1)
    inter = (torch.where(valid, total - picked, 0.0).sum((1, 2)) / hw).sum()
    return var, inter


def dml_segmentation_loss(logits, labels, *, alpha: float = 0.01,
                          beta: float = 0.0, ignore_index: int = -1,
                          group=None):
    """The SegmentationModule training loss. Returns
    ``(loss, (ce, var, inter, acc))``, over the global batch with a
    ``group``."""
    logits = _at_least_float32(logits)
    valid = labels != ignore_index
    nll, count = _nll_sum(logits, labels, ignore_index)
    var, inter = _var_inter(logits, labels, valid)
    nll, count, var, inter, n = _sum_over(group, nll, count, var, inter,
                                          logits.shape[0])
    ce = nll / count.clamp(min=1)
    loss = ce / n + alpha * var / n + beta * inter / n
    return loss, (ce, var, inter, pixel_acc(logits, labels, group))


def deeplab_cross_entropy(logits, labels, features_in=None, *,
                          alpha: float = 0.0, beta: float = 0.0,
                          gamma: float = 0.0, ignore_index: int = 255,
                          use_metric_terms: bool = False, num_classes=None,
                          group=None):
    """utils/loss.py:25-82. The active reference path is ``CE / n``.

    With ``use_metric_terms`` the reference's dead-code terms come in:
    ``(CE + alpha*VAR + beta*Inter + gamma*Center) / n``, VAR and Inter as
    in ``dml_segmentation_loss`` and Center the within-class spread of
    ``features_in`` (B, H, W, C): per image and class the mean embedding of
    the class's valid pixels, then the squared distance of each valid pixel
    to its class's mean, summed per image over its full pixel count.
    ``num_classes`` (default the logits' K) is the JAX package's one-hot
    width: a label at or above it counts in no class. With a ``group``
    each term is the global batch's."""
    logits = _at_least_float32(logits)
    nll, count = _nll_sum(logits, labels, ignore_index)
    if not use_metric_terms:
        nll, count, n = _sum_over(group, nll, count, logits.shape[0])
        return nll / count.clamp(min=1) / n

    hw = logits.shape[1] * logits.shape[2]
    valid = labels != ignore_index
    var, inter = _var_inter(logits, labels, valid)

    center = torch.zeros((), dtype=logits.dtype, device=logits.device)
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

    nll, count, var, inter, center, n = _sum_over(
        group, nll, count, var, inter, center, logits.shape[0])
    ce = nll / count.clamp(min=1)
    return (ce + alpha * var + beta * inter + gamma * center) / n


def focal_loss(logits, labels, *, alpha: float = 1.0, gamma: float = 0.0,
               ignore_index: int = 255, size_average: bool = True,
               group=None):
    """utils/loss.py:7-23: ``alpha * (1 - pt)^gamma * CE`` per pixel, 0 at
    ignored pixels; the mean over ALL pixels (torch's
    ``F.cross_entropy(reduction='none').mean()``) or the sum, of the
    global batch with a ``group``."""
    logits = _at_least_float32(logits)
    valid = labels != ignore_index
    ce = torch.logsumexp(logits, dim=-1) - _gather_logit(logits, labels)
    ce = torch.where(valid, ce, 0.0)
    pt = torch.exp(-ce)
    fl = torch.where(valid, alpha * (1 - pt) ** gamma * ce, 0.0)
    if group is None:
        return fl.mean() if size_average else fl.sum()
    total, count = _sum_over(group, fl.sum(), fl.numel())
    return total / count if size_average else total


def distillation_loss(logits, labels, features_1, features_2, *,
                      ignore_index: int = 255, novel_class: int = 16,
                      use_distillation_term: bool = False,
                      dis_weight: float = 0.01, group=None):
    """utils/loss.py:84-122 (CrossEntropyLoss_dis). The active reference
    path is ``CE / n``. With ``use_distillation_term``, plus ``dis_weight``
    times, per image, the mean over its non-novel pixels of the squared
    distance between the student's features ``features_2`` and the
    teacher's ``features_1`` zero-padded by one channel (loss.py:106-107),
    summed over the batch and divided by n. With a ``group`` each term is
    the global batch's."""
    logits = _at_least_float32(logits)
    nll, count = _nll_sum(logits, labels, ignore_index)
    if not use_distillation_term:
        nll, count, n = _sum_over(group, nll, count, logits.shape[0])
        return nll / count.clamp(min=1) / n

    f2 = _at_least_float32(features_2)
    f1 = torch.nn.functional.pad(features_1.to(f2.dtype), (0, 1))
    keep = (labels != novel_class)[..., None]
    diff = torch.where(keep, f2 - f1, 0.0)
    counts = keep.sum((1, 2, 3)).clamp(min=1)
    dis = ((diff ** 2).sum((1, 2, 3)) / counts.to(diff.dtype)).sum()
    nll, count, dis, n = _sum_over(group, nll, count, dis, logits.shape[0])
    return nll / count.clamp(min=1) / n + dis_weight * dis / n
