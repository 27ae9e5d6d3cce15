"""HRNetV2-W48 encoder, NCHW: the JAX package's ``models/hrnet.py``
(anomaly models/hrnet.py).

Topology: two 3x3 stride-2 conv-bn-relu (64 channels), ``layer1`` of four
``Bottleneck`` (64 -> 256), then stages 2-4 of 1, 4 and 3
``HighResolutionModule`` over 2, 3 and 4 branches of (48, 96, 192, 384)
channels, four ``BasicBlock`` per branch. The output is branch 0 and the
other branches resized to its size (``ops/resize.py bilinear_resize``),
concatenated: 720 channels at stride 4, one map in a list.

Each fuse mirrors the reference: a coarser branch j > i through a 1x1
conv-bn and a resize, a finer one j < i through i - j stride-2 3x3
conv-bn, with a ReLU on all but the last; the sums through a ReLU.

Key names are the reference's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``transition1.0.0`` for an adapted branch, ``transition1.1.0.0`` for a new
one, ``stage2.0.branches.0.0.conv1``, ``stage2.0.fuse_layers.0.1.0``,
``stage3.0.fuse_layers.2.0.0.0``). ``stage_channels`` and
``stage_modules`` are constructor arguments, so tests build it narrow.
``fused_blocks=True`` routes ``layer1``'s bottlenecks through the fused
kernel where ``fused_block_tile`` takes them (``models/resnet.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from .layers import BNConfig, ConvBN
from .resnet import BasicBlock, Bottleneck
from ..ops.resize import bilinear_resize

W48_CHANNELS = ((48, 96), (48, 96, 192), (48, 96, 192, 384))
W48_MODULES = (1, 4, 3)


def _resize(x, size):
    return bilinear_resize(x, size, channel_last=False)


class _FuseDown(nn.Sequential):
    """A finer branch j into branch i > j: i - j stride-2 3x3 conv-bn, a
    ReLU after all but the last; the last one widens to ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int, steps: int,
                 bn: BNConfig):
        super().__init__(*(
            ConvBN(in_channels, out_channels if k == steps - 1
                   else in_channels, 3, 2, padding=1,
                   relu=k != steps - 1, bn=bn)
            for k in range(steps)))


class HighResolutionModule(nn.Module):
    def __init__(self, num_channels: Sequence[int], num_blocks: int = 4,
                 multi_scale_output: bool = True,
                 bn: BNConfig = BNConfig()):
        super().__init__()
        nc = list(num_channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, c, bn=bn)
                            for _ in range(num_blocks))) for c in nc)
        self.fuse_layers = None
        if len(nc) > 1:
            self.fuse_layers = nn.ModuleList(nn.ModuleList(
                None if j == i
                else ConvBN(nc[j], nc[i], 1, relu=False, bn=bn) if j > i
                else _FuseDown(nc[j], nc[i], i - j, bn)
                for j in range(len(nc)))
                for i in range(len(nc) if multi_scale_output else 1))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, layers in enumerate(self.fuse_layers):
            y = ys[0] if i == 0 else layers[0](ys[0])
            for j in range(1, len(ys)):
                if j == i:
                    y = y + ys[j]
                elif j > i:
                    y = y + _resize(layers[j](ys[j]), ys[i].shape[-2:])
                else:
                    y = y + layers[j](ys[j])
            fused.append(torch.relu(y))
        return fused


class HRNetV2(nn.Module):
    def __init__(self, stage_channels=W48_CHANNELS,
                 stage_modules=W48_MODULES, bn: BNConfig = BNConfig(),
                 fused_blocks: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, padding=1, bias=False)
        self.bn1 = bn.make(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, padding=1, bias=False)
        self.bn2 = bn.make(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(*(
            Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0, bn=bn,
                       fused=fused_blocks) for b in range(4)))
        self.n_stages = len(stage_channels)
        prev = [256]
        for s, (channels, n_modules) in enumerate(zip(stage_channels,
                                                      stage_modules)):
            # an existing branch adapted where its width changes, a new
            # one grown by a stride-2 conv from the last branch
            setattr(self, f"transition{s + 1}", nn.ModuleList(
                (None if prev[i] == ch
                 else ConvBN(prev[i], ch, 3, padding=1, bn=bn))
                if i < len(prev)
                else nn.Sequential(ConvBN(prev[-1], ch, 3, 2, padding=1,
                                          bn=bn))
                for i, ch in enumerate(channels)))
            setattr(self, f"stage{s + 2}", nn.Sequential(*(
                HighResolutionModule(channels, bn=bn)
                for _ in range(n_modules))))
            prev = list(channels)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in range(self.n_stages):
            xs = [(xs[i] if t is None else t(xs[i])) if i < len(xs)
                  else t(xs[-1])
                  for i, t in enumerate(getattr(self, f"transition{s + 1}"))]
            xs = getattr(self, f"stage{s + 2}")(xs)
        size = xs[0].shape[-2:]
        return [torch.cat([xs[0]] + [_resize(b, size) for b in xs[1:]],
                          dim=1)]


def hrnetv2(**kw):
    return HRNetV2(**kw)
