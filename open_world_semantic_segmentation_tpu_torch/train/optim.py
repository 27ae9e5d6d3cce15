"""SGD with the poly schedule and the anomaly stack's parameter groups.

Counterpart of the JAX package's ``train/optim.py`` (``poly_schedule``,
``torch_sgd``, ``two_group_optimizer``), which writes torch's SGD in optax;
here it is ``torch.optim.SGD`` itself:

- momentum ``b = mu * b + g``, dampening 0, no Nesterov; weight decay added
  to the gradient first. The momentum buffers start at zero, as optax's
  ``trace`` does, so the first step's buffer is the gradient either way;
- weight decay on conv and linear weights only, never on biases or batch
  norm: the JAX ``decay_mask`` ("leaf name == kernel") read on the port's
  modules, since a BN scale is also named ``weight`` here;
- encoder and decoder in separate groups (anomaly/train.py:95-130), each
  on its own schedule. A group's learning rate at step s is
  ``schedule(s)``, s the number of steps the optimizer has taken before
  this one, which is the count optax's ``scale_by_schedule`` reads.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn as nn

Schedule = Union[float, Callable[[int], float]]


def poly_schedule(base_lr: float, max_iters: int, power: float = 0.9,
                  min_lr: float = 0.0) -> Callable[[int], float]:
    """``base_lr * max(1 - step / max_iters, 0) ** power``, at least
    ``min_lr`` (anomaly/train.py:133-142)."""
    def schedule(step: int) -> float:
        frac = max(1.0 - step / max_iters, 0.0)
        return max(base_lr * frac ** power, min_lr)
    return schedule


def decays(module: nn.Module, name: str) -> bool:
    """Whether ``module``'s parameter ``name`` takes weight decay."""
    return isinstance(module, (nn.Conv2d, nn.Linear)) and name == "weight"


def two_group_optimizer(model: nn.Module, *, lr_encoder: Schedule,
                        lr_decoder: Schedule, momentum: float = 0.9,
                        weight_decay: float = 1e-4,
                        encoder_keys=("encoder",)) -> torch.optim.SGD:
    """``torch.optim.SGD`` over ``model``'s parameters: the top-level
    children named in ``encoder_keys`` on ``lr_encoder``, the rest on
    ``lr_decoder``, each split into decayed and undecayed weights. Each
    group carries its ``schedule``; ``set_learning_rates`` applies it."""
    groups = {}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            part = ("encoder" if mod_name.split(".")[0] in encoder_keys
                    else "decoder")
            groups.setdefault((part, decays(module, name)), []).append(p)
    schedules = {"encoder": lr_encoder, "decoder": lr_decoder}
    param_groups = [
        {"params": params, "part": part,
         "weight_decay": weight_decay if decay else 0.0,
         "schedule": (schedules[part] if callable(schedules[part])
                      else (lambda _, lr=schedules[part]: lr))}
        for (part, decay), params in groups.items()]
    opt = torch.optim.SGD(param_groups, lr=0.0, momentum=momentum,
                          dampening=0.0, nesterov=False)
    set_learning_rates(opt, 0)
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p]["momentum_buffer"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
    return opt


def set_learning_rates(optimizer: torch.optim.Optimizer, step: int):
    """Each group's learning rate for the update after ``step`` updates."""
    for group in optimizer.param_groups:
        group["lr"] = group["schedule"](step)
