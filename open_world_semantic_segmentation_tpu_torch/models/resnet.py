"""ResNet backbones with declarative dilation, NCHW.

``resnet18`` / ``resnet34`` stack ``BasicBlock``, ``resnet50`` /
``resnet101`` ``Bottleneck`` (``models/resnext.py`` subclasses it). Covers
the CSAIL "deep stem" variant (three 3x3 convs, 128 channels into
layer1) that the anomaly stack uses, with the dilation surgery of its
``ResnetDilated``, and the torchvision 7x7 stem (one 7x7 stride-2 conv, 64
channels into layer1) with ``replace_stride_with_dilation`` that the DeepLab
stack uses (``resnet_deeplab``). Dilation follows from ``output_stride`` at
construction: when a stage's stride becomes 1, its first block keeps the
previous dilation and later blocks use the new one, which is what both
reference mechanisms produce.

Attribute names are the reference's (``conv1``, ``bn1``, ``layer3.0.conv2``,
``layer3.0.downsample.0``, ...), so its ``encoder_epoch_*.pth`` loads with
``load_state_dict``, and so does a DeepLab ``model_state`` under
``backbone.``. The forward returns the four stage outputs.

``fused_blocks=True`` routes every eligible ``Bottleneck`` (eval mode,
stride 1, one group, a geometry ``ops.fused_block.fused_block_tile``
accepts) through the kernel of ``ops/fused_block.py``: three launches per
block (conv1, conv2, conv3 with the skip, each with its bias, activation
and rounding fused) instead of three convolutions, a skip and two
activations. It is off by default; the choice per block is made once, at
construction.

``quant`` (``models/layers.py``, ``ops/quant.py``) quantizes the blocks of
``quant_stages`` (0-based; default 1-3, so the stem and layer1 stay in
float, as in the JAX package); it refuses ``fused_blocks``, since the JAX
package has no quantized fused block.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import BNConfig, ConvBN, make_conv
from ..ops.fused_block import fold_convbn, fused_block_tile, fused_bottleneck
from ..ops.pool import max_pool_3x3_s2_p1


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, first_dilation: int = 1,
                 downsample: bool = False, bn: BNConfig = BNConfig(),
                 groups: int = 1, base_width: int = 64, quant: str = "off"):
        super().__init__()
        self.conv1 = make_conv(inplanes, planes, 3, stride, first_dilation,
                               first_dilation, quant=quant)
        self.bn1 = bn.make(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = make_conv(planes, planes, 3, 1, dilation, dilation,
                               quant=quant)
        self.bn2 = bn.make(planes)
        self.downsample = (ConvBN(inplanes, planes, 1, stride, relu=False,
                                  bn=bn, quant=quant)
                           if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, first_dilation: int = 1,
                 downsample: bool = False, bn: BNConfig = BNConfig(),
                 groups: int = 1, base_width: int = 64, fused: bool = False,
                 quant: str = "off"):
        super().__init__()
        width = self.width(planes, groups, base_width)
        out_ch = planes * self.expansion
        self.conv1 = make_conv(inplanes, width, 1, quant=quant)
        self.bn1 = bn.make(width)
        # the 3x3 carries stride and dilation (torch Bottleneck layout)
        self.conv2 = make_conv(width, width, 3, stride, first_dilation,
                               first_dilation, groups, quant=quant)
        self.bn2 = bn.make(width)
        self.conv3 = make_conv(width, out_ch, 1, quant=quant)
        self.bn3 = bn.make(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (ConvBN(inplanes, out_ch, 1, stride,
                                  relu=False, bn=bn, quant=quant)
                           if downsample else None)
        # the fused route's tile, or None where the block stays unfused
        self.fused_tile = None
        if fused and stride == 1 and groups == 1:
            self.fused_tile = fused_block_tile(inplanes, width, out_ch,
                                               first_dilation)
        self._folded = {}     # (dtype, device) -> folded kernel weights

    @staticmethod
    def width(planes: int, groups: int, base_width: int) -> int:
        """The 3x3's channel count (torchvision's ``Bottleneck``)."""
        return int(planes * (base_width / 64.0)) * groups

    def forward(self, x):
        if self.fused_tile is not None and not self.training:
            return self._fused_forward(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)

    # -- fused route ------------------------------------------------------
    def _fused_forward(self, x):
        """The block through ``fused_bottleneck`` (three kernel launches
        on the card). Autocast does not reach the kernel, so the route
        casts x and the weights to the autocast dtype itself. A
        channels_last NCHW input is a contiguous NHWC tensor, and the
        output is returned as the channels_last NCHW view of the kernel's
        NHWC result."""
        dtype = x.dtype
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
        key = (dtype, x.device)
        if key not in self._folded:
            self._folded[key] = self._fold(dtype, x.device)
        xh = x.to(dtype).permute(0, 2, 3, 1).contiguous()
        out = fused_bottleneck(xh, *self._folded[key],
                               dilation=self.conv2.dilation[0])
        return out.permute(0, 3, 1, 2)

    @torch.no_grad()
    def _fold(self, dtype, device):
        """(w1, b1, w2, b2, w3, b3, wd, bd): BN folded into the convs in
        float32, weights in the kernel's layout and ``dtype``."""
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3)]
        if self.downsample is not None:
            pairs.append((self.downsample[0], self.downsample[1]))
        folded = []
        for conv, bn in pairs:
            w, b = fold_convbn(conv.weight, bn.weight, bn.bias,
                               bn.running_mean, bn.running_var, bn.eps)
            if conv.kernel_size == (1, 1):
                w = w[0, 0]
            folded += [w.to(device, dtype).contiguous(), b.to(device)]
        if self.downsample is None:
            folded += [None, None]
        return folded

    # the folded weights follow the parameters: dropped on train()/eval(),
    # load_state_dict and moves between devices or dtypes
    def train(self, mode: bool = True):
        self._folded = {}
        return super().train(mode)

    def _apply(self, *args, **kwargs):
        self._folded = {}
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded = {}
        return super()._load_from_state_dict(*args, **kwargs)


def _stage_plan(output_stride: int) -> Sequence[Tuple[int, int]]:
    """(stride, dilation) per stage for layers 1-4.

    output_stride 32: strides (1,2,2,2) dilations (1,1,1,1)
    output_stride 16: strides (1,2,2,1) dilations (1,1,1,2)
    output_stride 8:  strides (1,2,1,1) dilations (1,1,2,4)
    """
    if output_stride == 32:
        return [(1, 1), (2, 1), (2, 1), (2, 1)]
    if output_stride == 16:
        return [(1, 1), (2, 1), (2, 1), (1, 2)]
    if output_stride == 8:
        return [(1, 1), (2, 1), (1, 2), (1, 4)]
    raise ValueError(f"unsupported output_stride {output_stride}")


class ResNet(nn.Module):
    """Feature-pyramid ResNet returning [c1out..c4out] (NCHW)."""

    def __init__(self, block=Bottleneck, layers=(3, 4, 6, 3),
                 stem: str = "deep", output_stride: int = 8,
                 bn: BNConfig = BNConfig(), groups: int = 1,
                 base_width: int = 64, planes=(64, 128, 256, 512),
                 fused_blocks: bool = False, quant: str = "off",
                 quant_stages: Sequence[int] = (1, 2, 3)):
        super().__init__()
        if fused_blocks and quant != "off":
            raise ValueError("fused_blocks with quant: the fused bottleneck "
                             "has no quantized form")
        if fused_blocks and block is not Bottleneck:
            raise ValueError(f"fused_blocks routes Bottleneck blocks only, "
                             f"not {block.__name__}")
        fused = {"fused": True} if fused_blocks else {}
        if stem not in ("deep", "7x7"):
            raise ValueError(f"unknown stem {stem!r}")
        self.stem = stem
        if stem == "deep":
            self.conv1 = nn.Conv2d(3, 64, 3, 2, padding=1, bias=False)
            self.bn1 = bn.make(64)
            self.conv2 = nn.Conv2d(64, 64, 3, padding=1, bias=False)
            self.bn2 = bn.make(64)
            self.conv3 = nn.Conv2d(64, 128, 3, padding=1, bias=False)
            self.bn3 = bn.make(128)
            inplanes = 128
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
            self.bn1 = bn.make(64)
            inplanes = 64
        self.relu = nn.ReLU(inplace=True)

        prev_dilation = 1
        for stage, (nblocks, (stride, dilation)) in enumerate(
                zip(layers, _stage_plan(output_stride))):
            out_ch = planes[stage] * block.expansion
            blocks = []
            for b in range(nblocks):
                is_first = b == 0
                blocks.append(block(
                    inplanes, planes[stage],
                    stride=stride if is_first else 1,
                    dilation=dilation,
                    # first block of a dilated stage keeps the previous
                    # dilation (torchvision previous_dilation; CSAIL
                    # _nostride_dilate dilate//2 on the strided conv)
                    first_dilation=prev_dilation if is_first else dilation,
                    downsample=is_first and (stride != 1
                                             or inplanes != out_ch),
                    bn=bn, groups=groups, base_width=base_width,
                    quant=quant if stage in quant_stages else "off",
                    **fused))
                inplanes = out_ch
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            prev_dilation = dilation

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        if self.stem == "deep":
            x = self.relu(self.bn2(self.conv2(x)))
            x = self.relu(self.bn3(self.conv3(x)))
        x = max_pool_3x3_s2_p1(x, channel_last=False)
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            outs.append(x)
        return outs


def resnet18(**kw):
    return ResNet(block=BasicBlock, layers=(2, 2, 2, 2), **kw)


def resnet34(**kw):
    return ResNet(block=BasicBlock, layers=(3, 4, 6, 3), **kw)


def resnet50(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 23, 3), **kw)


def resnet_deeplab(depth: int = 101, output_stride: int = 16,
                   bn: BNConfig = BNConfig(momentum=0.01), **kw):
    """torchvision-stem ResNet as the DeepLab stack uses it (OS16 default;
    the reference sets the backbone's BN momentum to 0.01)."""
    layers = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
    return ResNet(block=Bottleneck, layers=layers, stem="7x7",
                  output_stride=output_stride, bn=bn, **kw)
