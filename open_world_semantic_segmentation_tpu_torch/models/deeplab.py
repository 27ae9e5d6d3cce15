"""DeepLabV3 / DeepLabV3+ heads and model wrappers.

Counterpart of the JAX package's ``models/deeplab.py``, with the module
names of the reference (DeepLabV3Plus-Pytorch ``network/utils.py``), so its
``model_state`` loads with ``load_state_dict``: the wrapper holds
``backbone`` (the torchvision-stem ResNet) and ``classifier`` (the head);
the V3+ head holds ``project`` (low-level 1x1 to 48), ``aspp`` and
``classifier`` (3x3 fuse, BN, ReLU, 1x1 to the classes); ASPP holds
``convs.0`` (1x1), ``convs.1-3`` (dilated 3x3), ``convs.4`` (image pool)
and ``project`` (1x1 over the 1280-channel concat, BN, ReLU, dropout).

The ASPP projection is computed as the reference computes it, a concat and
a 1x1 conv. The JAX package's default per-branch projection sum and its
shift-dilated convs (``ops/dilated.py``) are the same function, written so
for XLA's layouts and tiling; here cuDNN takes the concat and the dilated
convs as they are (on an H100 it runs the rate-12 and rate-18 convs at
1024x2048 with a slow direct kernel: ``PERF.md`` §5 and ``ROADMAP.md``).

Wrappers take an NHWC image batch, as the JAX package does (a contiguous
NHWC batch viewed as NCHW is channels_last: no copy), run the modules in
NCHW and return NHWC maps at the input size. The embedding wrapper returns
``(logits, centers, features)``: distance logits against the one-hot
centers of magnitude 3, the centers (K, K), and the raw K-dim embedding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .layers import BNConfig, ConvBN, init_module
from .resnet import resnet_deeplab
from ..ops.distance import one_hot_center_logits
from ..ops.pool import global_avg_pool
from ..ops.resize import bilinear_resize

HEAD_BN = BNConfig(momentum=0.1)


class GlobalAvgPool(nn.Module):
    """``ops.pool.global_avg_pool`` of an NCHW batch, as a module (index 0
    of the reference's ``ASPPPooling`` Sequential)."""

    def forward(self, x):
        return global_avg_pool(x, channel_last=False)


class ASPPPooling(nn.Sequential):
    """Image-pool branch: global mean, 1x1 conv, BN, ReLU, then back to the
    input's size. The reference's bilinear upsample from 1x1 is a
    broadcast."""

    def __init__(self, in_channels: int, out_channels: int,
                 bn: BNConfig = HEAD_BN):
        super().__init__(GlobalAvgPool(),
                         nn.Conv2d(in_channels, out_channels, 1, bias=False),
                         bn.make(out_channels), nn.ReLU(inplace=True))

    def forward(self, x):
        return super().forward(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1, three dilated 3x3 and the image
    pool, concatenated and projected to 256 with dropout 0.1."""

    def __init__(self, in_channels: int, atrous_rates: Sequence[int] =
                 (6, 12, 18), out_channels: int = 256,
                 bn: BNConfig = HEAD_BN):
        super().__init__()
        convs = [ConvBN(in_channels, out_channels, 1, bn=bn)]
        convs += [ConvBN(in_channels, out_channels, 3, padding=r,
                         dilation=r, bn=bn) for r in atrous_rates]
        convs.append(ASPPPooling(in_channels, out_channels, bn))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            nn.Conv2d(len(convs) * out_channels, out_channels, 1,
                      bias=False),
            bn.make(out_channels), nn.ReLU(inplace=True), nn.Dropout(0.1))

    def forward(self, x):
        return self.project(torch.cat([conv(x) for conv in self.convs], 1))


def _fuse_classifier(in_channels: int, num_classes: int, bn: BNConfig):
    """3x3 fuse to 256, BN, ReLU, then the 1x1 classifier with a bias."""
    return [nn.Conv2d(in_channels, 256, 3, padding=1, bias=False),
            bn.make(256), nn.ReLU(inplace=True),
            nn.Conv2d(256, num_classes, 1)]


class DeepLabHeadV3Plus(nn.Module):
    """Low-level projection (48 channels) + ASPP + 3x3 fuse + 1x1
    classifier. Takes ``{"low_level": layer1, "out": layer4}`` (NCHW)."""

    def __init__(self, in_channels: int, low_level_channels: int,
                 num_classes: int, aspp_dilate: Sequence[int] = (12, 24, 36),
                 bn: BNConfig = HEAD_BN):
        super().__init__()
        self.project = ConvBN(low_level_channels, 48, 1, bn=bn)
        self.aspp = ASPP(in_channels, aspp_dilate, bn=bn)
        self.classifier = nn.Sequential(*_fuse_classifier(304, num_classes,
                                                          bn))

    def forward(self, feature):
        low = self.project(feature["low_level"])
        out = bilinear_resize(self.aspp(feature["out"]), low.shape[-2:],
                              channel_last=False)
        return self.classifier(torch.cat([low, out], 1))


class DeepLabHead(nn.Module):
    """V3 head (no low-level fusion): ASPP, 3x3 fuse, 1x1 classifier."""

    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate: Sequence[int] = (12, 24, 36),
                 bn: BNConfig = HEAD_BN):
        super().__init__()
        self.classifier = nn.Sequential(
            ASPP(in_channels, aspp_dilate, bn=bn),
            *_fuse_classifier(256, num_classes, bn))

    def forward(self, feature):
        return self.classifier(feature["out"])


class DeepLabV3Plus(nn.Module):
    """backbone -> head -> bilinear upsample to the input size. NHWC image
    batch in, NHWC logits out."""

    def __init__(self, backbone: nn.Module, classifier: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier

    def forward(self, x):
        outs = self.backbone(x.permute(0, 3, 1, 2))
        # the reference's IntermediateLayerGetter: layer1 and layer4
        y = self.classifier({"low_level": outs[0], "out": outs[-1]})
        return bilinear_resize(y.permute(0, 2, 3, 1), x.shape[1:3])


class DeepLabV3PlusEmbedding(DeepLabV3Plus):
    """Embedding wrapper: the upsampled K-dim embedding, distance logits
    against the one-hot centers of ``magnitude``. Returns (logits NHWK,
    centers (K, K), features NHWK), the reference's order."""

    def __init__(self, backbone: nn.Module, classifier: nn.Module,
                 magnitude: float = 3.0):
        super().__init__(backbone, classifier)
        self.magnitude = magnitude

    def forward(self, x):
        emb = super().forward(x)
        logits = one_hot_center_logits(emb, self.magnitude)
        k = emb.shape[-1]
        centers = self.magnitude * torch.eye(k, dtype=emb.dtype,
                                             device=emb.device)
        return logits, centers, emb


def _aspp_rates(output_stride: int) -> Tuple[int, int, int]:
    """OS8 -> (12, 24, 36), OS16 -> (6, 12, 18)."""
    return (12, 24, 36) if output_stride == 8 else (6, 12, 18)


def _v3plus(wrapper, depth, num_classes, output_stride, fused_blocks):
    bb = resnet_deeplab(depth, output_stride, fused_blocks=fused_blocks)
    head = DeepLabHeadV3Plus(2048, 256, num_classes,
                             _aspp_rates(output_stride))
    return wrapper(bb, head)


def deeplabv3plus_resnet101(num_classes=21, output_stride=16, *,
                            fused_blocks=False):
    return _v3plus(DeepLabV3Plus, 101, num_classes, output_stride,
                   fused_blocks)


def deeplabv3plus_resnet50(num_classes=21, output_stride=16, *,
                           fused_blocks=False):
    return _v3plus(DeepLabV3Plus, 50, num_classes, output_stride,
                   fused_blocks)


def deeplabv3_resnet101(num_classes=21, output_stride=16, *,
                        fused_blocks=False):
    bb = resnet_deeplab(101, output_stride, fused_blocks=fused_blocks)
    return DeepLabV3Plus(bb, DeepLabHead(2048, num_classes,
                                         _aspp_rates(output_stride)))


def deeplabv3plus_embedding_resnet101(num_classes=16, output_stride=16, *,
                                      fused_blocks=False):
    return _v3plus(DeepLabV3PlusEmbedding, 101, num_classes, output_stride,
                   fused_blocks)


def deeplabv3plus_embedding_resnet50(num_classes=16, output_stride=16, *,
                                     fused_blocks=False):
    """The embedding head on ResNet-50: the JAX package's API extension
    (the reference composes the embedding wrapper with ResNet-101)."""
    return _v3plus(DeepLabV3PlusEmbedding, 50, num_classes, output_stride,
                   fused_blocks)


def init_deeplab_weights(model: DeepLabV3Plus, generator: torch.Generator):
    """Random initialisation of the JAX package's schemes, drawn from
    ``generator``: backbone convs over fan_out, head convs over fan_in
    (kaiming normal), conv biases zero, BN weight 1 and bias 0."""
    init_module(model.backbone, generator, fan_out=True)
    init_module(model.classifier, generator, fan_out=False)
    return model
