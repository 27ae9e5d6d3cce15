"""MobileNetV2 backbones, NCHW, output-stride aware: the JAX package's
``models/mobilenet.py``.

One implementation covers both reference variants. They share the inverted
residual topology and differ in padding and in how their modules nest:

- ``style="torchvision"`` (DeepLabV3Plus-Pytorch network/backbone/
  mobilenetv2.py): the stem's 3x3 stride-2 conv has padding 0, and each
  ``InvertedResidual`` pads its *input* by ``fixed_padding(3, dilation)``
  (d on each side) before the expand 1x1 conv, so the pad ring passes
  through expand-BN-ReLU6 and is not zero when it reaches the depthwise
  conv, which has padding 0. A block's ``conv`` is ``[ConvBNReLU(pw),
  ConvBNReLU(dw), project conv, BN]`` (keys ``conv.0.0``, ``conv.1.0``,
  ``conv.2``, ``conv.3``; without the expand, ``conv.0.0``, ``conv.1``,
  ``conv.2``).
- ``style="csail"`` (anomaly models/mobilenet.py with the dilation surgery
  of models.py:348-387): the stem pads 1, the depthwise 3x3 pads by its own
  dilation and nothing pads the block's input. A block's ``conv`` is flat:
  ``[pw, BN, ReLU6, dw, BN, ReLU6, project, BN]`` (``conv.0``, ``conv.3``,
  ``conv.6``; without the expand ``conv.0``, ``conv.3``).

Dilation follows from ``output_stride`` by tracking the stride, as the
torchvision bookkeeping does; it gives each block the stride and dilation
the CSAIL ``_nostride_dilate`` surgery gives it: when a stage's stride
collapses, its first block keeps the previous dilation and later blocks
take the new one.

Adapters, with the reference's key names:

- ``MobileNetV2Dilated`` (CSAIL, ``mobilenetv2dilated``): ``features.0``
  (the stem) to ``features.17``; returns the outputs of features 2, 4, 7,
  14 and 17 (down_idx and the last block); the final 1280-channel 1x1 is
  not built.
- ``mobilenet_v2`` (DeepLab): ``low_level_features`` (features 0-3) and
  ``high_level_features`` (features 4-17, keeping their indices, as the
  reference's ``features[4:-1]`` slice does); returns ``[low_level, out]``
  (block 3's 24 channels at stride 4, block 17's 320).
"""

from __future__ import annotations

from collections import OrderedDict

import torch.nn as nn
import torch.nn.functional as F

from .layers import BNConfig

# (expand t, channels c, repeats n, stride s)
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
STYLES = ("torchvision", "csail")


def _conv(inp, oup, k, stride=1, padding=0, dilation=1, groups=1):
    return nn.Conv2d(inp, oup, k, stride, padding, dilation, groups,
                     bias=False)


def _conv_bn_relu6(inp, oup, k, stride, padding, dilation, groups, bn):
    """Conv + BN + ReLU6 as one Sequential (keys ``.0``, ``.1``)."""
    return nn.Sequential(_conv(inp, oup, k, stride, padding, dilation,
                               groups), bn.make(oup), nn.ReLU6(inplace=True))


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, dilation: int,
                 expand_ratio: int, style: str = "torchvision",
                 bn: BNConfig = BNConfig()):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        self.pad = dilation if style == "torchvision" else 0
        dw_pad = 0 if style == "torchvision" else dilation
        dw = (hidden, hidden, 3, stride, dw_pad, dilation, hidden)
        if style == "torchvision":
            layers = [_conv_bn_relu6(inp, hidden, 1, 1, 0, 1, 1, bn)] \
                if expand_ratio != 1 else []
            layers += [_conv_bn_relu6(*dw, bn), _conv(hidden, oup, 1),
                       bn.make(oup)]
        else:
            layers = [_conv(inp, hidden, 1), bn.make(hidden),
                      nn.ReLU6(inplace=True)] if expand_ratio != 1 else []
            layers += [_conv(*dw), bn.make(hidden), nn.ReLU6(inplace=True),
                       _conv(hidden, oup, 1), bn.make(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = x if self.pad == 0 else F.pad(x, (self.pad,) * 4)
        y = self.conv(y)
        return x + y if self.use_res else y


def mobilenet_v2_features(output_stride: int = 8, style: str = "torchvision",
                          bn: BNConfig = BNConfig()):
    """The stem and the 17 inverted residual blocks, in order (width
    multiplier 1: 32 channels out of the stem)."""
    if style not in STYLES:
        raise ValueError(f"style {style!r}: one of {STYLES}")
    stem_pad = 0 if style == "torchvision" else 1
    features = [_conv_bn_relu6(3, 32, 3, 2, stem_pad, 1, 1, bn)]
    inp, current_stride, dilation = 32, 2, 1
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        previous_dilation = dilation
        if current_stride == output_stride:
            stride = 1
            dilation *= s
        else:
            stride = s
            current_stride *= s
        for i in range(n):
            features.append(InvertedResidual(
                inp, c, stride if i == 0 else 1,
                previous_dilation if i == 0 else dilation, t, style, bn))
            inp = c
    return features


class MobileNetV2Dilated(nn.Module):
    """The CSAIL encoder ``mobilenetv2dilated``: five feature maps (NCHW),
    of features 2, 4, 7, 14 and 17."""

    OUTPUTS = (2, 4, 7, 14, 17)

    def __init__(self, output_stride: int = 8, bn: BNConfig = BNConfig()):
        super().__init__()
        self.features = nn.Sequential(
            *mobilenet_v2_features(output_stride, "csail", bn))

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.OUTPUTS:
                outs.append(x)
        return outs


class MobileNetV2DeepLab(nn.Module):
    """The DeepLab backbone: ``[low_level, out]`` (NCHW), block 3's output
    and block 17's."""

    def __init__(self, output_stride: int = 16, style: str = "torchvision",
                 bn: BNConfig = BNConfig()):
        super().__init__()
        features = list(enumerate(mobilenet_v2_features(output_stride, style,
                                                        bn)))
        self.low_level_features = nn.Sequential(OrderedDict(
            (str(i), m) for i, m in features[:4]))
        self.high_level_features = nn.Sequential(OrderedDict(
            (str(i), m) for i, m in features[4:]))

    def forward(self, x):
        low = self.low_level_features(x)
        return [low, self.high_level_features(low)]


def mobilenet_v2(output_stride: int = 16, style: str = "torchvision",
                 bn: BNConfig = BNConfig()):
    return MobileNetV2DeepLab(output_stride, style, bn)

