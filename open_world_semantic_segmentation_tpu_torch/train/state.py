"""The anomaly stack's train step.

Counterpart of the JAX package's ``train/state.py`` ``make_anomaly_train_step``
(the reference's ``anomaly/train.py:20-75``): forward in training mode,
``dml_segmentation_loss`` on the distance logits, backward, one SGD update
of both parameter groups, batch-norm running statistics updated as flax
updates them. ``AnomalyTrainStep`` holds the model, the optimizer and the
step count; calling it runs one step and returns its metrics as device
tensors, so a step costs no host synchronisation. The caller puts the model
in training mode (``cli/_common.build_anomaly_model(train=True)``).

Precision: ``dtype=torch.bfloat16`` runs the forward under autocast over
float32 parameters (the JAX package's ``dtype=bf16`` convention); float32
(or float64, with float64 parameters) runs it as it is. The loss is taken
in at least float32.

Dropout draws from PyTorch's default generator of the model's device
(``torch.manual_seed``); nn.Dropout takes no generator of its own.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .guard import all_finite, save_state, select_update
from .losses import cross_entropy, dml_segmentation_loss
from .optim import set_learning_rates
from ..models.layers import BatchNorm2d

_AUTOCAST = (torch.bfloat16, torch.float16)


class AnomalyTrainStep:
    """One SegmentationModule train step per call:
    ``loss = CE/n + alpha*VAR/n`` (+ ``beta*Inter/n``).

    ``deep_sup_scale``: add ``deep_sup_scale * CE(deepsup) / n``, the
    auxiliary loss the reference ships commented out (off by default, as
    the JAX CLI leaves it). ``fix_bn``: normalise with batch statistics but
    keep the running ones. ``log_softmax_scores``: the loss reads
    log-softmax outputs (the non-embedding decoders). ``guard``: skip a
    step whose loss or gradients are not finite (``train/guard.py``).
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 *, alpha: float = 0.01, beta: float = 0.0,
                 deep_sup_scale: Optional[float] = None,
                 ignore_index: int = -1, guard: bool = False,
                 fix_bn: bool = False, log_softmax_scores: bool = False,
                 dtype=torch.bfloat16):
        self.model = model
        self.optimizer = optimizer
        self.alpha = alpha
        self.beta = beta
        self.deep_sup_scale = deep_sup_scale
        self.ignore_index = ignore_index
        self.guard = guard
        self.log_softmax_scores = log_softmax_scores
        self.dtype = dtype
        self.step = 0
        self._saved = None
        # every parameter updates every step, as in optax: the ones the
        # loss does not reach (the deep-supervision branch when its loss is
        # off) take zero gradients, so weight decay and momentum still apply
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.update_stats = not fix_bn

    def _state(self):
        """What a skipped step restores: parameters, batch-norm buffers
        and momentum buffers."""
        params = [p.data for p in self.model.parameters()]
        buffers = [b for b in self.model.buffers()]
        momentum = [self.optimizer.state[p]["momentum_buffer"]
                    for g in self.optimizer.param_groups
                    for p in g["params"]]
        return params + buffers + momentum

    def __call__(self, batch) -> dict:
        img, label = batch["img_data"], batch["seg_label"]
        device = img.device
        if self.guard:
            self._saved = save_state(self._state(), self._saved)
        set_learning_rates(self.optimizer, self.step)
        with torch.autocast(device.type, dtype=self.dtype,
                            enabled=self.dtype in _AUTOCAST):
            out = self.model(img)
        logits = out["scores"]
        if self.log_softmax_scores:
            logits = torch.log_softmax(logits, dim=-1)
        loss, (_, _, _, acc) = dml_segmentation_loss(
            logits, label, alpha=self.alpha, beta=self.beta,
            ignore_index=self.ignore_index)
        if self.deep_sup_scale is not None and "deepsup" in out:
            loss = loss + self.deep_sup_scale * cross_entropy(
                out["deepsup"], label, self.ignore_index) / logits.shape[0]
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        metrics = {"loss": loss.detach(), "acc": acc}
        if self.guard:
            grads = [p.grad for p in self.model.parameters()]
            finite = all_finite(grads) & torch.isfinite(loss.detach())
        self.optimizer.step()
        self.step += 1
        if self.guard:
            select_update(finite, self._state(), self._saved)
            metrics["skipped"] = ~finite
        return metrics
