"""The train steps.

Counterpart of the JAX package's ``train/state.py``: ``TrainStep`` is one
step of forward in training mode, loss, backward and SGD update, with
batch-norm running statistics updated as flax updates them (or kept, with
``fix_bn``) and the non-finite guard. A step object holds the model, the
optimizer and the step count; calling it runs one step and returns its
metrics as device tensors, so a step costs no host synchronisation. The
caller puts the model in training mode. Subclasses give the loss:

- ``AnomalyTrainStep``: ``make_anomaly_train_step`` (the reference's
  ``anomaly/train.py:20-75``), ``dml_segmentation_loss`` on the distance
  logits;
- ``DeepLabTrainStep``: ``make_deeplab_train_step`` (main.py:355-418),
  ``CE / n`` or the focal loss; a multi-head model trains its last head;
- ``cli/self_distillation.py SelfDistillationStep`` and
  ``cli/main_distillation.py DistillationStep``.

Parameters with ``requires_grad`` False (frozen by
``train/optim.py backbone_classifier_optimizer``) are neither updated nor
saved by the guard.

Precision: ``dtype=torch.bfloat16`` runs the forward under autocast over
float32 parameters (the JAX package's ``dtype=bf16`` convention); float32
(or float64, with float64 parameters) runs it as it is. The loss is taken
in at least float32.

Dropout draws from PyTorch's default generator of the model's device
(``torch.manual_seed``); nn.Dropout takes no generator of its own.

Data parallel (``group``, the default process group when
``torch.distributed`` is initialised): each rank runs the step on its
share of the global batch. Batch norm normalises with the global batch's
statistics, the loss is the global batch's (``train/losses.py``), and
after the backward one flat all-reduce averages the gradients
(``parallel/mesh.py average_gradients``), so every rank takes the update
one process takes on the global batch and ends the step with the same
bits. The guard then reads the reduced gradients and the
global loss, and reaches the same verdict on every rank. An explicit
all-reduce rather than ``DistributedDataParallel``: the step gives every
trained parameter a gradient whether the loss reaches it or not, which
DDP's search for unused parameters would trip over; the guard must see
the reduced gradients before the update; and the module needs no wrapper
(its state-dict keys stay the reference's). Each rank draws dropout masks
from its own generator (the CLIs seed it with the seed plus the rank), so
a multi-rank step's masks differ from one process's, and from the JAX
package's, by design.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .guard import all_finite, save_state, select_update
from .losses import (cross_entropy, deeplab_cross_entropy,
                     dml_segmentation_loss, focal_loss, pixel_acc)
from .optim import set_learning_rates
from ..models.layers import BatchNorm2d
from ..parallel.mesh import average_gradients, data_group, world_size

_AUTOCAST = (torch.bfloat16, torch.float16)


class TrainStep:
    """One train step per call; ``loss(batch)`` returns ``(loss, metrics)``.

    ``fix_bn``: normalise with batch statistics but keep the running ones.
    ``guard``: skip a step whose loss or gradients are not finite
    (``train/guard.py``). ``dtype``: the autocast dtype (bf16 or fp16), or
    the parameters' own dtype (float32, float64) to run as it is.
    ``group``: the data-parallel ranks (the default group when
    ``torch.distributed`` is initialised, else one process)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 *, guard: bool = False, fix_bn: bool = False,
                 dtype=torch.bfloat16, group=None):
        self.model = model
        self.optimizer = optimizer
        self.guard = guard
        self.dtype = dtype
        self.group = data_group() if group is None else group
        self.step = 0
        self._saved = None
        self._params = [p for p in model.parameters() if p.requires_grad]
        # every trained parameter updates every step, as in optax: the
        # ones the loss does not reach (the deep-supervision branch when its
        # loss is off) take zero gradients, so weight decay and momentum
        # still apply
        for p in self._params:
            p.grad = torch.zeros_like(p)
        bn_group = self.group if world_size(self.group) > 1 else None
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.update_stats = not fix_bn
                m.group = bn_group

    def autocast(self, device: torch.device):
        return torch.autocast(device.type, dtype=self.dtype,
                              enabled=self.dtype in _AUTOCAST)

    def _state(self):
        """What a skipped step restores: trained parameters, buffers
        (batch-norm statistics) and momentum buffers."""
        momentum = [self.optimizer.state[p]["momentum_buffer"]
                    for g in self.optimizer.param_groups
                    for p in g["params"]]
        return ([p.data for p in self._params] + list(self.model.buffers())
                + momentum)

    def loss(self, batch):
        raise NotImplementedError

    def __call__(self, batch) -> dict:
        if self.guard:
            self._saved = save_state(self._state(), self._saved)
        set_learning_rates(self.optimizer, self.step)
        loss, metrics = self.loss(batch)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        if self.group is not None:
            average_gradients(self._params, self.group)
        metrics = {"loss": loss.detach(), **metrics}
        if self.guard:
            finite = (all_finite([p.grad for p in self._params])
                      & torch.isfinite(loss.detach()))
        self.optimizer.step()
        self.step += 1
        if self.guard:
            select_update(finite, self._state(), self._saved)
            metrics["skipped"] = ~finite
        return metrics


class AnomalyTrainStep(TrainStep):
    """The SegmentationModule step: ``loss = CE/n + alpha*VAR/n``
    (+ ``beta*Inter/n``) on ``batch["img_data"]``, ``batch["seg_label"]``.

    ``deep_sup_scale``: add ``deep_sup_scale * CE(deepsup) / n``, the
    auxiliary loss the reference ships commented out (off by default, as
    the JAX CLI leaves it). ``log_softmax_scores``: the loss reads
    log-softmax outputs (the non-embedding decoders).
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 *, alpha: float = 0.01, beta: float = 0.0,
                 deep_sup_scale: Optional[float] = None,
                 ignore_index: int = -1, guard: bool = False,
                 fix_bn: bool = False, log_softmax_scores: bool = False,
                 dtype=torch.bfloat16, group=None):
        super().__init__(model, optimizer, guard=guard, fix_bn=fix_bn,
                         dtype=dtype, group=group)
        self.alpha = alpha
        self.beta = beta
        self.deep_sup_scale = deep_sup_scale
        self.ignore_index = ignore_index
        self.log_softmax_scores = log_softmax_scores

    def loss(self, batch):
        img, label = batch["img_data"], batch["seg_label"]
        with self.autocast(img.device):
            out = self.model(img)
        logits = out["scores"]
        if self.log_softmax_scores:
            logits = torch.log_softmax(logits, dim=-1)
        loss, (_, _, _, acc) = dml_segmentation_loss(
            logits, label, alpha=self.alpha, beta=self.beta,
            ignore_index=self.ignore_index, group=self.group)
        if self.deep_sup_scale is not None and "deepsup" in out:
            n = logits.shape[0] * world_size(self.group)
            loss = loss + self.deep_sup_scale * cross_entropy(
                out["deepsup"], label, self.ignore_index, self.group) / n
        return loss, {"acc": acc}


LOSS_KINDS = ("cross_entropy", "focal_loss")


class DeepLabTrainStep(TrainStep):
    """The DeepLab step on ``batch["image"]`` (NHWC) and ``batch["label"]``:
    the model returns logits, or (logits, centers, features) (embedding
    wrappers), or per-head lists (self-distillation: the last head
    trains); ``CE / n`` (utils/loss.py:42, the active path) or the focal
    loss; pixel accuracy over the non-ignored pixels."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 *, loss_kind: str = "cross_entropy",
                 ignore_index: int = 255, guard: bool = False,
                 fix_bn: bool = False, dtype=torch.bfloat16, group=None):
        if loss_kind not in LOSS_KINDS:
            raise ValueError(f"loss_kind {loss_kind!r}: one of {LOSS_KINDS}")
        super().__init__(model, optimizer, guard=guard, fix_bn=fix_bn,
                         dtype=dtype, group=group)
        self.loss_kind = loss_kind
        self.ignore_index = ignore_index

    def loss(self, batch):
        img, label = batch["image"], batch["label"]
        with self.autocast(img.device):
            out = self.model(img)
        logits = out[0] if isinstance(out, tuple) else out
        if isinstance(logits, (list, tuple)):
            logits = logits[-1]
        if self.loss_kind == "focal_loss":
            loss = focal_loss(logits, label, ignore_index=self.ignore_index,
                              group=self.group)
        else:
            loss = deeplab_cross_entropy(logits, label,
                                         ignore_index=self.ignore_index,
                                         group=self.group)
        acc = pixel_acc(logits, torch.where(label == self.ignore_index, -1,
                                            label), self.group)
        return loss, {"acc": acc}
