"""The scene-parsing decoders, NCHW inside: the PPM deep-supervision ones
(the embedding one, the DML head, and the plain one), and C1, C1DeepSup,
PPM and UPerNet (the JAX package's ``models/decoders.py``).

Parity target: the reference's ``PPMDeepsup_embedding`` (anomaly
models.py:586-687) as the JAX package's ``models/decoders.py`` computes it:

- at inference (``seg_size`` given) there is no softmax: the decoder returns
  ``scores = resize(distance(emb))`` and ``ft = resize(emb)``, where ``emb``
  is the K-dim output of ``conv_last`` and the distance head is the fixed
  one-hot-center rule of ``ops/distance.py``;
- the fuse conv runs concat-free (``ops/ppm_fuse.py``), the JAX default;
- in training (no ``seg_size``) it returns ``scores``, ``deepsup`` (the
  deep-supervision branch off conv4) and ``embedding`` at feature
  resolution; ``ft``, the 4096-d concat the JAX package also returns
  there, is built only when asked (``concat_ft=True``): eager PyTorch would
  otherwise materialise it in every train step, which never reads it;
- dropout is element-wise (``nn.Dropout(0.1)``), as in the JAX package; the
  torch reference drops whole channels (``nn.Dropout2d``).

``PPMDeepsup`` (the reference's PPMDeepsup, models.py:515-584, the model of
``cli/test_closed.py`` and ``cli/eval_ood_rec.py``) is the same trunk and
head read as class logits: at inference it returns the raw logits resized
to ``seg_size`` (no softmax, whatever ``use_softmax`` says in the
reference) and, when asked (``want_ft=True``, which only
``cli/eval_ood_rec.py`` sets), ``ft``, the 4096-d PPM concat at feature
resolution, not resized; in training ``scores`` and ``deepsup``. The JAX
package returns ``ft`` always and its jit drops it where nothing reads it;
eager PyTorch would build it at every scale of every eval.

``C1``, ``C1DeepSup``, ``PPM`` and ``UPerNet`` (reference models.py
:404-462, :466-511, :690-777) keep the reference's quirk that the JAX
package keeps: no softmax at inference unless ``use_softmax`` is set, and
then after the resize. In training (no ``seg_size``) ``C1DeepSup`` also
returns ``deepsup`` off conv4, which ``train/state.py`` reads; at inference
the JAX package returns it too and its jit drops it where nothing reads it,
so the port leaves it out there, as ``PPMDeepsup`` leaves out ``ft``.
``UPerNet``'s lateral widths follow the encoder's ``fc_dim`` (its stages
are fc_dim / 8, / 4, / 2 and fc_dim wide: 256-2048 for the ResNet-50
family, 64-512 for ResNet-18); the JAX package reads them off its inputs.
``upernet_lite`` is ``fpn_dim`` 256, ``upernet`` 512.

``quant`` (the PPM deep-supervision decoders and ``PPM``; ``ops/quant.py``)
quantizes the pyramid branches and the fuse conv. The fuse conv runs
concat-free under ``off`` and ``int8-hybrid``, where a prequantized int8
weight's per-channel ``w_scale`` is applied after the conv (exact: the scale
commutes with the conv's sums); under ``int8``, ``int8-3x3``, ``w4a8`` and
``calib`` it runs over the materialised concat as a quantized ``ConvBN``
conv, as in the JAX package's ``_PPMHead``. The 1x1 classifiers and the
deep-supervision branch stay in float.

Modules keep the reference's key names (``ppm.0.1.weight``,
``conv_last.0.weight``, ``conv_last.4.bias``, ``cbr_deepsup.0.weight``,
``conv_last_deepsup.weight``; ``cbr.0.weight``, ``conv_last.weight``;
``ppm_conv.0.0.weight``, ``fpn_in.0.0.weight``, ``fpn_out.0.0.0.weight``,
``conv_last.0.0.weight``, ``conv_last.1.bias``). Outputs are NHWC, as in
the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import BNConfig, Conv, ConvBN, QuantConv2d, make_conv
from ..ops.distance import one_hot_center_logits
from ..ops.pool import adaptive_avg_pool
from ..ops.ppm_fuse import ppm_fuse_conv
from ..ops.resize import bilinear_resize

PPM_CHANNELS = 512


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _inference_scores(x, seg_size, use_softmax: bool):
    """NHWC class scores: as they are in training (no ``seg_size``), else
    resized to ``seg_size`` and, with ``use_softmax``, softmaxed there in
    the scores' dtype (CUDA autocast would return float32)."""
    if seg_size is None:
        return x
    x = bilinear_resize(x, seg_size)
    return torch.softmax(x, dim=-1).to(x.dtype) if use_softmax else x


class C1(nn.Module):
    """3x3 conv-bn-relu and a 1x1 classifier on the last feature map."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048,
                 use_softmax: bool = False, bn: BNConfig = BNConfig()):
        super().__init__()
        self.use_softmax = use_softmax
        self.cbr = ConvBN(fc_dim, fc_dim // 4, 3, padding=1, bn=bn)
        self.conv_last = Conv(fc_dim // 4, num_class)

    def forward(self, conv_out, seg_size=None):
        x = _nhwc(self.conv_last(self.cbr(conv_out[-1])))
        return {"scores": _inference_scores(x, seg_size, self.use_softmax)}


class C1DeepSup(C1):
    """C1 plus the deep-supervision branch off conv4 (training only)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048,
                 use_softmax: bool = False, bn: BNConfig = BNConfig()):
        super().__init__(num_class, fc_dim, use_softmax, bn)
        self.cbr_deepsup = ConvBN(fc_dim // 2, fc_dim // 4, 3, padding=1,
                                  bn=bn)
        self.conv_last_deepsup = Conv(fc_dim // 4, num_class)

    def forward(self, conv_out, seg_size=None):
        out = super().forward(conv_out, seg_size)
        if seg_size is None:
            out["deepsup"] = _nhwc(self.conv_last_deepsup(
                self.cbr_deepsup(conv_out[-2])))
        return out


class _PPMTrunk(nn.ModuleList):
    """Pyramid pooling branches: (adaptive pool -> 1x1 conv-bn-relu) per
    scale. Returns the pooled maps at their pyramid resolutions (k x k);
    the upsample + concat is left to the consumer."""

    def __init__(self, fc_dim: int, pool_scales, bn: BNConfig,
                 quant: str = "off"):
        super().__init__(
            nn.Sequential(nn.AdaptiveAvgPool2d(scale),
                          *ConvBN(fc_dim, PPM_CHANNELS, 1, bn=bn,
                                  quant=quant))
            for scale in pool_scales)

    def forward(self, conv5):
        return [branch(conv5) for branch in self]


def _ppm_concat(conv5, pools):
    """Materialised reference dataflow: cat(conv5, upsampled pools), NCHW;
    the reference the concat-free fuse is tested against."""
    size = conv5.shape[-2:]
    return torch.cat(
        [conv5] + [bilinear_resize(p, size, channel_last=False)
                   for p in pools], dim=1)


class _PPMHead(nn.Sequential):
    """conv_last: 3x3 conv-bn-relu (the fuse) -> dropout(0.1) -> 1x1 to
    num_class. The fuse conv's weight is applied concat-free under
    ``off`` and ``int8-hybrid``, else over the concat (module note)."""

    def __init__(self, in_channels: int, num_class: int, bn: BNConfig,
                 quant: str = "off"):
        if quant == "int8-hybrid":
            # the float dataflow, but a prequantized int8 weight and its
            # w_scale may come in
            fuse = QuantConv2d(in_channels, PPM_CHANNELS, 3, padding=1,
                               bias=False, mode="off")
        else:
            fuse = make_conv(in_channels, PPM_CHANNELS, 3, padding=1,
                             quant=quant)
        super().__init__(fuse, bn.make(PPM_CHANNELS), nn.ReLU(inplace=True),
                         nn.Dropout(0.1), Conv(PPM_CHANNELS, num_class))
        self.concat_free = quant in ("off", "int8-hybrid")

    def forward(self, conv5, pools):
        fuse, bn, relu, drop, out = self
        if not self.concat_free:
            return out(drop(relu(bn(fuse(_ppm_concat(conv5, pools))))))
        y = ppm_fuse_conv(_nhwc(conv5), [_nhwc(p) for p in pools],
                          fuse.weight)
        if fuse.weight.dtype == torch.int8:
            y = y * fuse.w_scale
        y = relu(bn(y.to(conv5.dtype).permute(0, 3, 1, 2)))
        return out(drop(y))


class _PPMDeepsupBase(nn.Module):
    """The trunk, the head and the deep-supervision branch off conv4 that
    both decoders share (``_deepsup`` runs the branch)."""

    def __init__(self, num_class: int, fc_dim: int, pool_scales,
                 bn: BNConfig, quant: str = "off"):
        super().__init__()
        self.ppm = _PPMTrunk(fc_dim, pool_scales, bn, quant)
        self.conv_last = _PPMHead(fc_dim + len(pool_scales) * PPM_CHANNELS,
                                  num_class, bn, quant)
        # deep supervision off conv4 (training only)
        self.cbr_deepsup = ConvBN(fc_dim // 2, fc_dim // 4, 3, padding=1,
                                  bn=bn)
        self.dropout_deepsup = nn.Dropout(0.1)
        self.conv_last_deepsup = Conv(fc_dim // 4, num_class)

    def _deepsup(self, conv4):
        return _nhwc(self.conv_last_deepsup(self.dropout_deepsup(
            self.cbr_deepsup(conv4))))


class PPMDeepsup(_PPMDeepsupBase):
    """Raw class logits and, with ``want_ft``, the 4096-d PPM concat as
    ``ft`` (the features of reconstruction scoring)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6), bn: BNConfig = BNConfig(),
                 quant: str = "off"):
        super().__init__(num_class, fc_dim, pool_scales, bn, quant)

    def forward(self, conv_out, seg_size=None, want_ft: bool = False):
        conv5 = conv_out[-1]
        pools = self.ppm(conv5)
        x = _nhwc(self.conv_last(conv5, pools))
        if seg_size is None:
            return {"scores": x, "deepsup": self._deepsup(conv_out[-2])}
        out = {"scores": bilinear_resize(x, seg_size)}
        if want_ft:
            out["ft"] = _nhwc(_ppm_concat(conv5, pools))
        return out


class PPM(nn.Module):
    """The pyramid pooling trunk and head, no deep supervision."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6), use_softmax: bool = False,
                 bn: BNConfig = BNConfig(), quant: str = "off"):
        super().__init__()
        self.use_softmax = use_softmax
        self.ppm = _PPMTrunk(fc_dim, pool_scales, bn, quant)
        self.conv_last = _PPMHead(fc_dim + len(pool_scales) * PPM_CHANNELS,
                                  num_class, bn, quant)

    def forward(self, conv_out, seg_size=None):
        conv5 = conv_out[-1]
        x = _nhwc(self.conv_last(conv5, self.ppm(conv5)))
        return {"scores": _inference_scores(x, seg_size, self.use_softmax)}


class PPMDeepsupEmbedding(_PPMDeepsupBase):
    """PPMDeepsup trunk whose K-dim conv output is read as a pixel
    embedding; logits are -||x - m*e_k||^2 against fixed one-hot centers
    (magnitude 3)."""

    def __init__(self, num_class: int = 13, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6), magnitude: float = 3.0,
                 bn: BNConfig = BNConfig(), quant: str = "off"):
        super().__init__(num_class, fc_dim, pool_scales, bn, quant)
        self.magnitude = magnitude

    def forward(self, conv_out, seg_size=None, concat_ft: bool = False):
        conv5 = conv_out[-1]
        pools = self.ppm(conv5)
        emb = _nhwc(self.conv_last(conv5, pools))
        scores = one_hot_center_logits(emb, self.magnitude)
        if seg_size is not None:
            # ``ft`` is the pre-distance K-dim map: the 4096-d concat never
            # materialises on the eval path
            return {"scores": bilinear_resize(scores, seg_size),
                    "ft": bilinear_resize(emb, seg_size)}
        out = {"scores": scores, "deepsup": self._deepsup(conv_out[-2]),
               "embedding": emb}
        if concat_ft:
            out["ft"] = _nhwc(_ppm_concat(conv5, pools))
        return out


class UPerNet(nn.Module):
    """FPN over the four feature maps with a pyramid pooling module on the
    last; ``fpn_dim`` 512 (``upernet``) or 256 (``upernet_lite``)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 pool_scales=(1, 2, 3, 6), fpn_dim: int = 256,
                 use_softmax: bool = False, bn: BNConfig = BNConfig()):
        super().__init__()
        fpn_inplanes = (fc_dim // 8, fc_dim // 4, fc_dim // 2, fc_dim)
        self.use_softmax = use_softmax
        self.pool_scales = tuple(pool_scales)
        self.ppm_conv = nn.ModuleList(
            ConvBN(fc_dim, PPM_CHANNELS, 1, bn=bn) for _ in pool_scales)
        self.ppm_last_conv = ConvBN(
            fc_dim + len(pool_scales) * PPM_CHANNELS, fpn_dim, 3, padding=1,
            bn=bn)
        self.fpn_in = nn.ModuleList(ConvBN(c, fpn_dim, 1, bn=bn)
                                    for c in fpn_inplanes[:-1])
        self.fpn_out = nn.ModuleList(
            nn.Sequential(ConvBN(fpn_dim, fpn_dim, 3, padding=1, bn=bn))
            for _ in fpn_inplanes[:-1])
        self.conv_last = nn.Sequential(
            ConvBN(len(fpn_inplanes) * fpn_dim, fpn_dim, 3, padding=1,
                   bn=bn),
            Conv(fpn_dim, num_class))

    def forward(self, conv_out, seg_size=None):
        conv5 = conv_out[-1]
        size5 = conv5.shape[-2:]
        ppm_out = [conv5] + [
            conv(bilinear_resize(adaptive_avg_pool(
                conv5, scale, channel_last=False), size5, channel_last=False))
            for scale, conv in zip(self.pool_scales, self.ppm_conv)]
        f = self.ppm_last_conv(torch.cat(ppm_out, dim=1))
        features = [f]
        for i in reversed(range(len(conv_out) - 1)):
            lateral = self.fpn_in[i](conv_out[i])
            f = lateral + bilinear_resize(f, lateral.shape[-2:],
                                          channel_last=False)
            features.append(self.fpn_out[i](f))
        features.reverse()
        size = features[0].shape[-2:]
        fusion = [features[0]] + [bilinear_resize(p, size, channel_last=False)
                                  for p in features[1:]]
        x = _nhwc(self.conv_last(torch.cat(fusion, dim=1)))
        return {"scores": _inference_scores(x, seg_size, self.use_softmax)}
