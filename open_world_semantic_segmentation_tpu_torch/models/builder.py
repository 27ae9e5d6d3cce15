"""Encoder/decoder factory with the reference ``ModelBuilder`` arch names,
plus the combined segmentation model and its random initialisation.

Every name of the JAX package's ``ModelBuilder`` builds: the encoders
``resnet18``, ``resnet34``, ``resnet50``, ``resnet101`` (output stride 32)
and their ``dilated`` forms (8), ``resnext101``, ``hrnetv2`` and
``mobilenetv2dilated``; the decoders ``c1``, ``c1_deepsup``, ``ppm``,
``ppm_deepsup``, ``ppm_deepsup_embedding``, ``upernet`` and
``upernet_lite``. An unknown name raises ``ValueError``, as in the JAX
package.

``fused_blocks=True`` routes the encoder's eligible ResNet ``Bottleneck``
blocks through the fused kernel (inference only): the ResNet-50/101
families and HRNet's ``layer1``. An encoder without such blocks
(``BasicBlock`` ResNets, ResNeXt, MobileNet) raises rather than run
unfused.

``quant`` (``ops/quant.py``): the int8 PTQ modes, inference only, wired as
in the JAX package for the ResNet and ResNeXt encoders (``quant_stages``,
0-based, default layers 2-4) and the PPM decoders; any other encoder or
decoder, ``train=True`` or ``fused_blocks`` with a mode other than ``off``
raises ``ValueError``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn as nn

from .decoders import (C1, C1DeepSup, PPM, PPMDeepsup, PPMDeepsupEmbedding,
                       UPerNet)
from .hrnet import hrnetv2
from .layers import BNConfig, init_module
from .mobilenet import MobileNetV2Dilated
from .resnet import resnet18, resnet34, resnet50, resnet101
from .resnext import resnext101
from ..ops.quant import check_quant

# decoder BN bias of the reference's ModelBuilder.weights_init
DECODER_BN_BIAS = 1e-4


class SegmentationModel(nn.Module):
    """encoder -> decoder. Takes an NHWC image batch and returns the
    decoder's NHWC dict: upsampled to ``seg_size`` (inference), or at
    feature resolution without it (training). Other keywords go to the
    decoder."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, img: torch.Tensor, seg_size=None, **decoder_kw):
        # a contiguous NHWC batch viewed as NCHW is channels_last: no copy
        conv_out = self.encoder(img.permute(0, 3, 1, 2))
        return self.decoder(conv_out, seg_size=seg_size, **decoder_kw)


# encoder name -> (factory, output stride)
_RESNETS = {
    "resnet18": (resnet18, 32), "resnet18dilated": (resnet18, 8),
    "resnet34": (resnet34, 32), "resnet34dilated": (resnet34, 8),
    "resnet50": (resnet50, 32), "resnet50dilated": (resnet50, 8),
    "resnet101": (resnet101, 32), "resnet101dilated": (resnet101, 8),
}
# decoder name -> (class, extra keywords)
_DECODERS = {
    "c1": (C1, {}), "c1_deepsup": (C1DeepSup, {}), "ppm": (PPM, {}),
    "ppm_deepsup": (PPMDeepsup, {}),
    "ppm_deepsup_embedding": (PPMDeepsupEmbedding, {}),
    "upernet_lite": (UPerNet, {"fpn_dim": 256}),
    "upernet": (UPerNet, {"fpn_dim": 512}),
}
# the decoders that take ``use_softmax`` (the PPM deep-supervision ones
# return raw scores whatever the reference's flag says)
_SOFTMAX_DECODERS = ("c1", "c1_deepsup", "ppm", "upernet_lite", "upernet")


class ModelBuilder:
    """Name-compatible factory: arch strings match the reference configs."""

    ENCODER_FC_DIM = {
        "mobilenetv2dilated": 320,
        "resnet18": 512, "resnet18dilated": 512,
        "resnet34": 512, "resnet34dilated": 512,
        "resnet50": 2048, "resnet50dilated": 2048,
        "resnet101": 2048, "resnet101dilated": 2048,
        "resnext101": 2048,
        "hrnetv2": 720,
    }
    # the encoders with ResNet Bottleneck blocks, which fused_blocks routes
    FUSED_ENCODERS = ("resnet50", "resnet50dilated", "resnet101",
                      "resnet101dilated", "hrnetv2")

    @staticmethod
    def build_encoder(arch="resnet50dilated", *,
                      bn: Optional[BNConfig] = None,
                      fused_blocks: bool = False, quant: str = "off",
                      quant_stages=None):
        arch = arch.lower()
        bn = bn or BNConfig()
        qkw = {}
        if check_quant(quant) != "off":
            if not arch.startswith(("resnet", "resnext")):
                raise ValueError(
                    f"int8 quantization is wired for the ResNet/ResNeXt "
                    f"families only (got {arch})")
            if fused_blocks:
                raise ValueError("fused_blocks with quant: the fused "
                                 "bottleneck has no quantized form")
            qkw["quant"] = quant
            if quant_stages is not None:
                qkw["quant_stages"] = tuple(quant_stages)
        if arch in _RESNETS:
            factory, output_stride = _RESNETS[arch]
            return factory(stem="deep", output_stride=output_stride, bn=bn,
                           fused_blocks=fused_blocks, **qkw)
        if arch == "resnext101":
            return resnext101(bn=bn, fused_blocks=fused_blocks, **qkw)
        if arch == "hrnetv2":
            return hrnetv2(bn=bn, fused_blocks=fused_blocks)
        if arch == "mobilenetv2dilated":
            if fused_blocks:
                raise ValueError("fused_blocks routes ResNet Bottleneck "
                                 "blocks; mobilenetv2dilated has none")
            return MobileNetV2Dilated(output_stride=8, bn=bn)
        raise ValueError(f"Architecture undefined: {arch}")

    @staticmethod
    def build_decoder(arch="ppm_deepsup_embedding", fc_dim=2048,
                      num_class=13, use_softmax=False, *,
                      bn: Optional[BNConfig] = None, quant: str = "off"):
        arch = arch.lower()
        if arch not in _DECODERS:
            raise ValueError(f"Architecture undefined: {arch}")
        cls, kw = _DECODERS[arch]
        if arch in _SOFTMAX_DECODERS:
            kw = {**kw, "use_softmax": use_softmax}
        if check_quant(quant) != "off":
            if not arch.startswith("ppm"):
                raise ValueError(
                    f"int8 quantization is wired for the PPM decoder "
                    f"family only (got {arch})")
            kw = {**kw, "quant": quant}
        return cls(num_class=num_class, fc_dim=fc_dim, bn=bn or BNConfig(),
                   **kw)

    @staticmethod
    def build_segmentation_model(arch_encoder, arch_decoder, num_class,
                                 fc_dim=None, use_softmax=False, *,
                                 bn: Optional[BNConfig] = None,
                                 fused_blocks: bool = False,
                                 train: bool = False, quant: str = "off",
                                 quant_stages=None):
        """The decoder is as wide as the encoder's output
        (``ENCODER_FC_DIM``): a torch decoder's first convs take that many
        channels, where flax reads them off the input, so an ``fc_dim`` that
        differs (a config's 2048 beside a 512-wide ResNet-18) cannot be
        honoured and gets a warning. ``fused_blocks``: route the encoder's
        eligible bottlenecks through the fused kernel; off by default.
        ``train``: the model's mode (eval by default). ``quant``: "off", or
        an int8 PTQ mode (``ops/quant.py``): build with "calib", run
        ``ops.quant.calibrate`` over a few images, then prequantize the
        model built with the eval's mode; inference only."""
        if quant != "off" and train:
            raise ValueError("int8 PTQ is an inference-only mode")
        encoder = ModelBuilder.build_encoder(arch_encoder, bn=bn,
                                             fused_blocks=fused_blocks,
                                             quant=quant,
                                             quant_stages=quant_stages)
        width = ModelBuilder.ENCODER_FC_DIM[arch_encoder.lower()]
        if fc_dim and fc_dim != width:
            warnings.warn(f"fc_dim {fc_dim}: {arch_encoder} is {width} "
                          f"wide; using {width}")
        fc_dim = width
        decoder = ModelBuilder.build_decoder(arch_decoder, fc_dim, num_class,
                                             use_softmax, bn=bn, quant=quant)
        return SegmentationModel(encoder, decoder).train(train)


def init_weights(model: SegmentationModel, generator: torch.Generator):
    """Random initialisation of the JAX package's (and the reference's)
    schemes, drawn from ``generator``:

    - encoder convs: normal(0, sqrt(2 / (kh * kw * out_channels)));
    - decoder convs: kaiming normal over fan_in, biases zero;
    - BN: weight 1, bias 0 (encoder) or 1e-4 (decoder); running stats
      mean 0, var 1.
    """
    init_module(model.encoder, generator, fan_out=True)
    init_module(model.decoder, generator, fan_out=False,
                bn_bias=DECODER_BN_BIAS)
    return model
