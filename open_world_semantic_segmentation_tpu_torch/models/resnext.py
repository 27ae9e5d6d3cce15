"""ResNeXt-101 encoder (the CSAIL deep-stem variant, anomaly
models/resnext.py), the JAX package's ``models/resnext.py``.

``GroupBottleneck`` is the port's ``Bottleneck`` with expansion 2 and a 3x3
of ``planes`` channels in ``groups`` groups (32 in ``resnext101``), per-stage
widths 128-1024; the reference wraps it in the plain ``Resnet`` feature
extractor (no dilation surgery), so ``resnext101`` has output stride 32.
Key names are the reference's (``layer3.0.conv2``, ``layer3.0.downsample.0``,
...). Its grouped 3x3 does not take the fused route (``Bottleneck`` routes
``groups == 1`` only), and ``ResNet`` refuses ``fused_blocks`` for it.
"""

from __future__ import annotations

from .layers import BNConfig
from .resnet import Bottleneck, ResNet


class GroupBottleneck(Bottleneck):
    expansion = 2

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, first_dilation: int = 1,
                 downsample: bool = False, bn: BNConfig = BNConfig(),
                 groups: int = 32, base_width: int = 64, quant: str = "off"):
        super().__init__(inplanes, planes, stride, dilation, first_dilation,
                         downsample, bn, groups, base_width, quant=quant)

    @staticmethod
    def width(planes: int, groups: int, base_width: int) -> int:
        return planes


def resnext101(output_stride: int = 32, **kw):
    return ResNet(block=GroupBottleneck, layers=(3, 4, 23, 3), stem="deep",
                  output_stride=output_stride, groups=32,
                  planes=(128, 256, 512, 1024), **kw)
