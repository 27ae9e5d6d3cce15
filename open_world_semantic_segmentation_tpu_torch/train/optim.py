"""SGD with the poly schedule and the training stacks' parameter groups.

Counterpart of the JAX package's ``train/optim.py`` (``poly_schedule``,
``torch_sgd``, ``two_group_optimizer``, ``backbone_classifier_optimizer``),
which writes torch's SGD in optax; here it is ``torch.optim.SGD`` itself:

- momentum ``b = mu * b + g``, dampening 0, no Nesterov; weight decay added
  to the gradient first. The momentum buffers start at zero, as optax's
  ``trace`` does, so the first step's buffer is the gradient either way;
- weight decay on conv and linear weights only, never on biases or batch
  norm: the JAX ``decay_mask`` ("leaf name == kernel") read on the port's
  modules, since a BN scale is also named ``weight`` here;
- encoder and decoder in separate groups (anomaly/train.py:95-130), or
  the DeepLab backbone at a fraction of the heads' rate (main.py:296-299),
  each on its own schedule. A group's learning rate at step s is
  ``schedule(s)``, s the number of steps the optimizer has taken before
  this one, which is the count optax's ``scale_by_schedule`` reads;
- frozen subtrees (the JAX package's ``optax.set_to_zero``) take no update
  at all, neither momentum nor weight decay: their parameters are left out
  of the optimizer and get ``requires_grad_(False)``, which also skips
  their part of the backward.
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


def _grouped_sgd(model: nn.Module, part_of, schedules, momentum: float,
                 weight_decay: float) -> torch.optim.SGD:
    """``torch.optim.SGD`` over ``model``'s parameters, grouped by
    ``part_of(top-level child name)`` (None: frozen, left out and set to
    ``requires_grad_(False)``) and split into decayed and undecayed
    weights. Each group carries its part's ``schedule``;
    ``set_learning_rates`` applies it."""
    groups = {}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            part = part_of(mod_name.split(".")[0])
            if part is None:
                p.requires_grad_(False)
                continue
            groups.setdefault((part, decays(module, name)), []).append(p)
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


def two_group_optimizer(model: nn.Module, *, lr_encoder: Schedule,
                        lr_decoder: Schedule, momentum: float = 0.9,
                        weight_decay: float = 1e-4,
                        encoder_keys=("encoder",)) -> torch.optim.SGD:
    """The top-level children named in ``encoder_keys`` on ``lr_encoder``,
    the rest on ``lr_decoder``."""
    return _grouped_sgd(
        model, lambda top: "encoder" if top in encoder_keys else "decoder",
        {"encoder": lr_encoder, "decoder": lr_decoder}, momentum,
        weight_decay)


def backbone_classifier_optimizer(model: nn.Module, *, lr: Schedule,
                                  momentum: float = 0.9,
                                  weight_decay: float = 1e-4,
                                  backbone_scale: float = 0.1,
                                  backbone_keys=("backbone",),
                                  frozen_keys=()) -> torch.optim.SGD:
    """DeepLab: the top-level children in ``backbone_keys`` at
    ``backbone_scale * lr``, the heads at ``lr``; the children in
    ``frozen_keys`` frozen (self-distillation trains only its newest head,
    test_self_distillation.py:476-478)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def part_of(top):
        if top in frozen_keys:
            return None
        return "backbone" if top in backbone_keys else "head"

    return _grouped_sgd(
        model, part_of,
        {"backbone": lambda step: backbone_scale * lr_fn(step),
         "head": lr_fn}, momentum, weight_decay)


def set_learning_rates(optimizer: torch.optim.Optimizer, step: int):
    """Each group's learning rate for the update after ``step`` updates."""
    for group in optimizer.param_groups:
        group["lr"] = group["schedule"](step)


def optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` without the groups' schedules (functions,
    which a checkpoint does not hold)."""
    state = optimizer.state_dict()
    state["param_groups"] = [{k: v for k, v in g.items() if k != "schedule"}
                             for g in state["param_groups"]]
    return state


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict):
    """Restore ``optimizer_state``'s output, keeping each group's
    schedule."""
    schedules = [g["schedule"] for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, schedule in zip(optimizer.param_groups, schedules):
        group["schedule"] = schedule
