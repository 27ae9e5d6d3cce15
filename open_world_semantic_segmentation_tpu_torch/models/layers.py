"""Shared building blocks: conv + batch-norm + activation, inference only.

Modules keep the reference's torch ``state_dict`` key names, so its
checkpoints load with plain ``load_state_dict``: ``ConvBN`` is a
``Sequential`` (conv at index 0, BN at 1), which gives the reference's
``downsample.0`` / ``downsample.1`` and ``cbr_deepsup.0`` / ``.1`` keys.
"""

from __future__ import annotations

import dataclasses

import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class BNConfig:
    """Batch-norm settings shared across a model (torch momentum convention:
    new = (1 - m) * running + m * batch)."""

    momentum: float = 0.1
    epsilon: float = 1e-5

    def make(self, num_features: int) -> nn.BatchNorm2d:
        return nn.BatchNorm2d(num_features, eps=self.epsilon,
                              momentum=self.momentum)


class ConvBN(nn.Sequential):
    """Conv2d (no bias) + BatchNorm2d + optional ReLU, NCHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1, relu: bool = True,
                 bn: BNConfig = BNConfig()):
        layers = [nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                            padding, dilation, groups, bias=False),
                  bn.make(out_channels)]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def Conv(in_channels: int, out_channels: int, kernel_size: int = 1,
         stride: int = 1, padding: int = 0, dilation: int = 1,
         groups: int = 1, use_bias: bool = True) -> nn.Conv2d:
    """Plain torch Conv2d (bias optional), the JAX ``Conv`` wrapper's
    counterpart."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding,
                     dilation, groups, bias=use_bias)
