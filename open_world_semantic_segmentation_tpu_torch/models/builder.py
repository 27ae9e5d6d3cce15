"""Encoder/decoder factory with the reference ``ModelBuilder`` arch names,
plus the combined segmentation model and its random initialisation.

Wired so far: ``resnet50dilated`` with ``ppm_deepsup_embedding`` (the
StreetHazards open-set eval model) or ``ppm_deepsup`` (the closed-set and
reconstruction evals). Other arch names raise ``NotImplementedError``;
``ROADMAP.md`` queues them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .decoders import PPMDeepsup, PPMDeepsupEmbedding
from .layers import BNConfig, init_module
from .resnet import resnet50

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


def _not_ported(kind: str, arch: str):
    return NotImplementedError(
        f"{kind} {arch!r} is not ported yet; ROADMAP.md queues it")


class ModelBuilder:
    """Name-compatible factory: arch strings match the reference configs."""

    ENCODER_FC_DIM = {"resnet50dilated": 2048}

    @staticmethod
    def build_encoder(arch="resnet50dilated", *,
                      bn: Optional[BNConfig] = None,
                      fused_blocks: bool = False):
        arch = arch.lower()
        if arch == "resnet50dilated":
            return resnet50(stem="deep", output_stride=8,
                            bn=bn or BNConfig(), fused_blocks=fused_blocks)
        raise _not_ported("encoder", arch)

    @staticmethod
    def build_decoder(arch="ppm_deepsup_embedding", fc_dim=2048,
                      num_class=13, *, bn: Optional[BNConfig] = None):
        arch = arch.lower()
        decoders = {"ppm_deepsup_embedding": PPMDeepsupEmbedding,
                    "ppm_deepsup": PPMDeepsup}
        if arch in decoders:
            return decoders[arch](num_class=num_class, fc_dim=fc_dim,
                                  bn=bn or BNConfig())
        raise _not_ported("decoder", arch)

    @staticmethod
    def build_segmentation_model(arch_encoder, arch_decoder, num_class,
                                 fc_dim=None, *,
                                 bn: Optional[BNConfig] = None,
                                 fused_blocks: bool = False):
        """``fused_blocks``: route the encoder's eligible bottlenecks
        through the fused kernel (``models/resnet.py``); off by default."""
        encoder = ModelBuilder.build_encoder(arch_encoder, bn=bn,
                                             fused_blocks=fused_blocks)
        fc_dim = fc_dim or ModelBuilder.ENCODER_FC_DIM[arch_encoder.lower()]
        decoder = ModelBuilder.build_decoder(arch_decoder, fc_dim, num_class,
                                             bn=bn)
        return SegmentationModel(encoder, decoder)


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
