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
a 1x1 conv; the JAX package's default per-branch projection sum is the
same function, written so for XLA's layouts. The ASPP's dilated 3x3 convs
(rate 6 or more) take the shift form of ``ops/dilated.py`` by default, as
in the JAX package: on an H100 cuDNN runs the rate-12 and rate-18 convs of
the 1024x2048 eval in bf16 channels_last with a slow direct kernel
(``PERF.md`` §5). ``dilated_impl="native"`` on the factories keeps cuDNN's
conv. The state-dict keys are the same either way.

The MobileNet factories (``deeplabv3plus_mobilenet``,
``deeplabv3_mobilenet``, ``deeplabv3plus_embedding_mobilenet``) put the
heads on ``models/mobilenet.py mobilenet_v2``: the low-level features of
block 3 (24 channels) and the ASPP on block 17 (320). They have no
bottleneck for the fused route, and refuse ``fused_blocks``; ``style``
picks the backbone's padding (``"torchvision"``, the reference's, or
``"csail"``).

The self-distillation wrapper (FT / PLM incremental learning) shares one
backbone across the base head ``classifier`` (16 classes) and novel heads
``classifier_1`` .. ``classifier_N`` of 16 + i classes, each a full V3+
head with its own ASPP, and returns per-head lists.

``quant`` (``ops/quant.py``) is taken by the three factories that take it
in the JAX package: ``deeplabv3plus_resnet101``,
``deeplabv3plus_embedding_resnet101`` and
``deeplabv3plus_embedding_resnet50``; the others have no such keyword,
so a call with one raises ``TypeError``. ``_split_quant`` maps a mode to (backbone, head): ``int8-hybrid``
quantizes the backbone alone (``calib-hybrid`` calibrates it alone), every
other mode both. In the head the ASPP's branches (but its image pool), its
projection, the low-level projection and the 3x3 fuse conv quantize; the
final 1x1 classifier stays in float. The ASPP computes its projection over
the concat in every mode, so a quantized projection needs no other
dataflow.

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

from .layers import BNConfig, ConvBN, init_module, make_conv
from .mobilenet import mobilenet_v2
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
                 bn: BNConfig = HEAD_BN, dilated_impl: str = "shift",
                 quant: str = "off"):
        super().__init__()
        convs = [ConvBN(in_channels, out_channels, 1, bn=bn, quant=quant)]
        convs += [ConvBN(in_channels, out_channels, 3, padding=r,
                         dilation=r, bn=bn, dilated_impl=dilated_impl,
                         quant=quant)
                  for r in atrous_rates]
        convs.append(ASPPPooling(in_channels, out_channels, bn))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            make_conv(len(convs) * out_channels, out_channels, 1,
                      quant=quant),
            bn.make(out_channels), nn.ReLU(inplace=True), nn.Dropout(0.1))

    def forward(self, x):
        return self.project(torch.cat([conv(x) for conv in self.convs], 1))


def _fuse_classifier(in_channels: int, num_classes: int, bn: BNConfig,
                     quant: str = "off"):
    """3x3 fuse to 256, BN, ReLU, then the 1x1 classifier with a bias (in
    float whatever ``quant`` says)."""
    return [make_conv(in_channels, 256, 3, padding=1, quant=quant),
            bn.make(256), nn.ReLU(inplace=True),
            nn.Conv2d(256, num_classes, 1)]


class DeepLabHeadV3Plus(nn.Module):
    """Low-level projection (48 channels) + ASPP + 3x3 fuse + 1x1
    classifier. Takes ``{"low_level": layer1, "out": layer4}`` (NCHW)."""

    def __init__(self, in_channels: int, low_level_channels: int,
                 num_classes: int, aspp_dilate: Sequence[int] = (12, 24, 36),
                 bn: BNConfig = HEAD_BN, dilated_impl: str = "shift",
                 quant: str = "off"):
        super().__init__()
        self.project = ConvBN(low_level_channels, 48, 1, bn=bn, quant=quant)
        self.aspp = ASPP(in_channels, aspp_dilate, bn=bn,
                         dilated_impl=dilated_impl, quant=quant)
        self.classifier = nn.Sequential(*_fuse_classifier(304, num_classes,
                                                          bn, quant))

    def forward(self, feature):
        low = self.project(feature["low_level"])
        out = bilinear_resize(self.aspp(feature["out"]), low.shape[-2:],
                              channel_last=False)
        return self.classifier(torch.cat([low, out], 1))


class DeepLabHead(nn.Module):
    """V3 head (no low-level fusion): ASPP, 3x3 fuse, 1x1 classifier."""

    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate: Sequence[int] = (12, 24, 36),
                 bn: BNConfig = HEAD_BN, dilated_impl: str = "shift",
                 quant: str = "off"):
        super().__init__()
        self.classifier = nn.Sequential(
            ASPP(in_channels, aspp_dilate, bn=bn, dilated_impl=dilated_impl,
                 quant=quant),
            *_fuse_classifier(256, num_classes, bn, quant))

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
        return _embedding_outputs(super().forward(x), self.magnitude)


def _embedding_outputs(emb, magnitude: float):
    """(distance logits, one-hot centers (K, K), emb) of an NHWK
    embedding."""
    centers = magnitude * torch.eye(emb.shape[-1], dtype=emb.dtype,
                                    device=emb.device)
    return one_hot_center_logits(emb, magnitude), centers, emb


class DeepLabV3PlusSelfDistillation(nn.Module):
    """Shared backbone, base head ``classifier`` of ``base_classes`` and
    novel heads ``classifier_1`` .. ``classifier_{cls_novel}`` of
    ``base_classes + i`` classes, each a V3+ head with its own ASPP.
    Returns (logits list, centers list, features list), one entry per
    head, base head first; each as the embedding wrapper returns it."""

    def __init__(self, backbone: nn.Module, base_classes: int = 16,
                 cls_novel: int = 1, aspp_dilate: Sequence[int] = (6, 12, 18),
                 magnitude: float = 3.0, in_channels: int = 2048,
                 low_level_channels: int = 256, dilated_impl: str = "shift"):
        super().__init__()
        self.backbone = backbone
        self.magnitude = magnitude
        self.head_names = ["classifier"] + [f"classifier_{i}"
                                            for i in range(1, cls_novel + 1)]
        for i, name in enumerate(self.head_names):
            self.add_module(name, DeepLabHeadV3Plus(
                in_channels, low_level_channels, base_classes + i,
                aspp_dilate, dilated_impl=dilated_impl))

    def forward(self, x):
        outs = self.backbone(x.permute(0, 3, 1, 2))
        feature = {"low_level": outs[0], "out": outs[-1]}
        heads = [_embedding_outputs(bilinear_resize(
            getattr(self, name)(feature).permute(0, 2, 3, 1), x.shape[1:3]),
            self.magnitude) for name in self.head_names]
        return tuple(list(out) for out in zip(*heads))


def _aspp_rates(output_stride: int) -> Tuple[int, int, int]:
    """OS8 -> (12, 24, 36), OS16 -> (6, 12, 18)."""
    return (12, 24, 36) if output_stride == 8 else (6, 12, 18)


def _split_quant(quant: str) -> Tuple[str, str]:
    """A factory's ``quant`` -> (backbone mode, head mode): ``int8-hybrid``
    is an int8 backbone under a float head, ``calib-hybrid`` its
    calibration twin (the scales recorded in the backbone alone, so that
    ``ops.quant.prequantize`` touches the backbone's weights alone)."""
    if quant == "int8-hybrid":
        return "int8", "off"
    if quant == "calib-hybrid":
        return "calib", "off"
    return quant, quant


def _v3plus(wrapper, depth, num_classes, output_stride, fused_blocks,
            dilated_impl, quant="off"):
    bq, hq = _split_quant(quant)
    bb = resnet_deeplab(depth, output_stride, fused_blocks=fused_blocks,
                        quant=bq)
    head = DeepLabHeadV3Plus(2048, 256, num_classes,
                             _aspp_rates(output_stride),
                             dilated_impl=dilated_impl, quant=hq)
    return wrapper(bb, head)


# Every factory takes ``fused_blocks`` (the backbone's eligible
# bottlenecks through the fused kernel, inference only), ``dilated_impl``
# ("shift", the default, or "native" for the ASPP's dilated convs); the
# three with the JAX package's ``quant`` take it too (module note).
def deeplabv3plus_resnet101(num_classes=21, output_stride=16, *,
                            fused_blocks=False, dilated_impl="shift",
                            quant="off"):
    return _v3plus(DeepLabV3Plus, 101, num_classes, output_stride,
                   fused_blocks, dilated_impl, quant)


def deeplabv3plus_resnet50(num_classes=21, output_stride=16, *,
                           fused_blocks=False, dilated_impl="shift"):
    return _v3plus(DeepLabV3Plus, 50, num_classes, output_stride,
                   fused_blocks, dilated_impl)


def deeplabv3_resnet101(num_classes=21, output_stride=16, *,
                        fused_blocks=False, dilated_impl="shift"):
    bb = resnet_deeplab(101, output_stride, fused_blocks=fused_blocks)
    return DeepLabV3Plus(bb, DeepLabHead(2048, num_classes,
                                         _aspp_rates(output_stride),
                                         dilated_impl=dilated_impl))


def deeplabv3plus_embedding_resnet101(num_classes=16, output_stride=16, *,
                                      fused_blocks=False,
                                      dilated_impl="shift", quant="off"):
    return _v3plus(DeepLabV3PlusEmbedding, 101, num_classes, output_stride,
                   fused_blocks, dilated_impl, quant)


def deeplabv3plus_embedding_resnet50(num_classes=16, output_stride=16, *,
                                     fused_blocks=False,
                                     dilated_impl="shift", quant="off"):
    """The embedding head on ResNet-50: the JAX package's API extension
    (the reference composes the embedding wrapper with ResNet-101)."""
    return _v3plus(DeepLabV3PlusEmbedding, 50, num_classes, output_stride,
                   fused_blocks, dilated_impl, quant)


def _mobilenet(wrapper, v3plus, num_classes, output_stride, fused_blocks,
               dilated_impl, style):
    if fused_blocks:
        raise ValueError("fused_blocks routes ResNet Bottleneck blocks; "
                         "MobileNetV2 has none")
    bb = mobilenet_v2(output_stride, style)
    rates = _aspp_rates(output_stride)
    head = (DeepLabHeadV3Plus(320, 24, num_classes, rates,
                              dilated_impl=dilated_impl) if v3plus
            else DeepLabHead(320, num_classes, rates,
                             dilated_impl=dilated_impl))
    return wrapper(bb, head)


def deeplabv3plus_mobilenet(num_classes=21, output_stride=16, *,
                            fused_blocks=False, dilated_impl="shift",
                            style="torchvision"):
    return _mobilenet(DeepLabV3Plus, True, num_classes, output_stride,
                      fused_blocks, dilated_impl, style)


def deeplabv3_mobilenet(num_classes=21, output_stride=16, *,
                        fused_blocks=False, dilated_impl="shift",
                        style="torchvision"):
    return _mobilenet(DeepLabV3Plus, False, num_classes, output_stride,
                      fused_blocks, dilated_impl, style)


def deeplabv3plus_embedding_mobilenet(num_classes=16, output_stride=16, *,
                                      fused_blocks=False,
                                      dilated_impl="shift",
                                      style="torchvision"):
    """The embedding head on MobileNetV2: the JAX package's API extension
    (the reference composes the embedding wrapper with ResNets)."""
    return _mobilenet(DeepLabV3PlusEmbedding, True, num_classes,
                      output_stride, fused_blocks, dilated_impl, style)


def deeplabv3plus_embedding_self_distillation_resnet101(
        num_classes=16, cls_novel=1, output_stride=16, *,
        fused_blocks=False, dilated_impl="shift"):
    bb = resnet_deeplab(101, output_stride, fused_blocks=fused_blocks)
    return DeepLabV3PlusSelfDistillation(
        bb, num_classes, cls_novel, _aspp_rates(output_stride),
        dilated_impl=dilated_impl)


def init_deeplab_weights(model: nn.Module, generator: torch.Generator):
    """Random initialisation of the JAX package's schemes, drawn from
    ``generator``: backbone convs over fan_out, head convs over fan_in
    (kaiming normal), conv biases zero, BN weight 1 and bias 0. Every
    child other than ``backbone`` is a head (``classifier``, and
    ``classifier_1`` .. of the self-distillation model)."""
    init_module(model.backbone, generator, fan_out=True)
    for name, child in model.named_children():
        if name != "backbone":
            init_module(child, generator, fan_out=False)
    return model
