"""JAX (flax) variables -> the port's torch state dicts.

The inverse of the JAX package's ``train/convert.py``
(``convert_segmentation_model``): the flax ``{"params", "batch_stats"}``
tree of a ``SegmentationModel``, given as numpy arrays, becomes the encoder
and decoder state dicts of the port, whose keys are the reference's. Conv
kernels go HWIO -> OIHW; BN ``scale/bias`` (params) and ``mean/var``
(batch_stats) go to ``weight/bias/running_mean/running_var``, in float32
(float64 arrays stay float64).

``deeplab_state_dict_from_jax`` does the same for the DeepLab models
(the inverse of the JAX package's ``convert_deeplab_checkpoint``): the
backbone's ``stem1`` becomes ``backbone.conv1`` / ``bn1``, the head goes
under ``classifier.`` with the reference's names; the self-distillation
model's heads ``classifier``, ``classifier_1`` .. keep their names (the
JAX ``convert_deeplab_checkpoint(head_names=...)``). The ASPP projection's
one (1, 1, 1280, 256) kernel is the same parameter whether the JAX package
computes it per branch or over the concat.

Every encoder and decoder family of the JAX ``ModelBuilder`` converts:
the ResNet rules cover ``BasicBlock`` and ``GroupBottleneck`` (ResNeXt) as
well as ``Bottleneck`` (the JAX ``_translate_resnet_key``), HRNet adds its
transitions and stage modules (``_translate_hrnet_key``), the CSAIL
MobileNet its ``features`` (``_translate_csail_mobilenet_key``); the
decoders are the PPM and C1 families (``_translate_decoder_key``) and
UPerNet (``_translate_upernet_key``), told apart by UPerNet's
``conv_fusion``. A DeepLab MobileNet backbone (the JAX ``backbone/net``)
becomes ``backbone.low_level_features`` / ``high_level_features``
(``_translate_mobilenet_key``) in the layout of its ``style``.

A quantized tree carries across too (``ops/quant.py``): an int8 or int4
kernel of a prequantized tree becomes an int8 weight (``QuantConv2d``
keeps it int8 when it loads), and ``quant_state_from_jax`` /
``deeplab_quant_state_from_jax`` turn the ``quant`` collection (``amax``
and ``w_scale``, kept by the JAX package at the ``ConvBN`` or ``PPMFuse``
beside its ``conv``) into the state ``ops.quant.load_quant_state`` takes,
keyed by the torch conv's module name.

The reference's own ``encoder_epoch_*.pth`` / ``decoder_epoch_*.pth`` and
DeepLab ``model_state`` need no conversion: they load into the port with
``load_state_dict``.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# flax module path -> torch module prefix
_ENCODER_RULES = (
    (r"stem(\d)/conv", r"conv\1"),
    (r"stem(\d)/bn", r"bn\1"),
    (r"layer(\d)_(\d+)/c(\d)/conv", r"layer\1.\2.conv\3"),
    (r"layer(\d)_(\d+)/c(\d)/bn", r"layer\1.\2.bn\3"),
    (r"layer(\d)_(\d+)/down/conv", r"layer\1.\2.downsample.0"),
    (r"layer(\d)_(\d+)/down/bn", r"layer\1.\2.downsample.1"),
)
# HRNet beyond its ResNet-named stem and layer1: a transition to a new
# branch (the last of its stage) is a Sequential of one conv-bn-relu
_HRNET_RULES = (
    (r"trans(\d)_(\d)/(conv|bn)",
     lambda m: "transition{}.{}.{}{}".format(
         int(m[1]) + 1, m[2], "0." if int(m[2]) == int(m[1]) + 1 else "",
         "0" if m[3] == "conv" else "1")),
    (r"stage(\d)_(\d+)/branch(\d)_(\d+)/c(\d)/(conv|bn)",
     r"stage\1.\2.branches.\3.\4.\6\5"),
    (r"stage(\d)_(\d+)/branch(\d)_(\d+)/down/conv",
     r"stage\1.\2.branches.\3.\4.downsample.0"),
    (r"stage(\d)_(\d+)/branch(\d)_(\d+)/down/bn",
     r"stage\1.\2.branches.\3.\4.downsample.1"),
    (r"stage(\d)_(\d+)/fuse(\d)_(\d)/d(\d)/conv",
     r"stage\1.\2.fuse_layers.\3.\4.\5.0"),
    (r"stage(\d)_(\d+)/fuse(\d)_(\d)/d(\d)/bn",
     r"stage\1.\2.fuse_layers.\3.\4.\5.1"),
    (r"stage(\d)_(\d+)/fuse(\d)_(\d)/conv",
     r"stage\1.\2.fuse_layers.\3.\4.0"),
    (r"stage(\d)_(\d+)/fuse(\d)_(\d)/bn",
     r"stage\1.\2.fuse_layers.\3.\4.1"),
)
# a MobileNetV2 inverted residual's layers, by flax module, relative to the
# block: (style, expand block?) -> index in its ``conv`` Sequential
_MOBILENET_LAYERS = {
    ("csail", True): {"expand/cb/conv": "0", "expand/cb/bn": "1",
                      "dw/cb/conv": "3", "dw/cb/bn": "4",
                      "project/conv": "6", "project/bn": "7"},
    ("csail", False): {"dw/cb/conv": "0", "dw/cb/bn": "1",
                       "project/conv": "3", "project/bn": "4"},
    ("torchvision", True): {"expand/cb/conv": "0.0", "expand/cb/bn": "0.1",
                            "dw/cb/conv": "1.0", "dw/cb/bn": "1.1",
                            "project/conv": "2", "project/bn": "3"},
    ("torchvision", False): {"dw/cb/conv": "0.0", "dw/cb/bn": "0.1",
                             "project/conv": "1", "project/bn": "2"},
}


def _mobilenet_rules(style: str, deeplab: bool):
    """The flax ``net/...`` paths of a MobileNetV2 of ``style``: under
    ``features`` (CSAIL), or split into ``low_level_features`` (blocks 0-3)
    and ``high_level_features`` (DeepLab)."""

    def features(index: int) -> str:
        if not deeplab:
            return f"features.{index}"
        part = "low" if index < 4 else "high"
        return f"{part}_level_features.{index}"

    def block(m):
        n = int(m[1])
        return "{}.conv.{}".format(
            features(n), _MOBILENET_LAYERS[(style, n != 1)][m[2]])

    return ((r"net/stem/cb/conv", lambda m: features(0) + ".0"),
            (r"net/stem/cb/bn", lambda m: features(0) + ".1"),
            (r"net/block(\d+)/(\w+/cb/\w+|project/\w+)", block))


_DECODER_RULES = (
    (r"ppm/ppm(\d)/conv", r"ppm.\1.1"),
    (r"ppm/ppm(\d)/bn", r"ppm.\1.2"),
    (r"conv_last/fuse/conv", "conv_last.0"),
    (r"conv_last/fuse/bn", "conv_last.1"),
    (r"conv_last/out/conv", "conv_last.4"),
    (r"deepsup/cbr_deepsup/conv", "cbr_deepsup.0"),
    (r"deepsup/cbr_deepsup/bn", "cbr_deepsup.1"),
    (r"deepsup/conv_last_deepsup/conv", "conv_last_deepsup"),
    # the C1 family
    (r"cbr/conv", "cbr.0"),
    (r"cbr/bn", "cbr.1"),
    (r"conv_last/conv", "conv_last"),
    (r"cbr_deepsup/conv", "cbr_deepsup.0"),
    (r"cbr_deepsup/bn", "cbr_deepsup.1"),
    (r"conv_last_deepsup/conv", "conv_last_deepsup"),
)
_UPERNET_RULES = (
    (r"ppm_conv(\d)/conv", r"ppm_conv.\1.0"),
    (r"ppm_conv(\d)/bn", r"ppm_conv.\1.1"),
    (r"ppm_last_conv/conv", "ppm_last_conv.0"),
    (r"ppm_last_conv/bn", "ppm_last_conv.1"),
    (r"fpn_in(\d)/conv", r"fpn_in.\1.0"),
    (r"fpn_in(\d)/bn", r"fpn_in.\1.1"),
    (r"fpn_out(\d)/conv", r"fpn_out.\1.0.0"),
    (r"fpn_out(\d)/bn", r"fpn_out.\1.0.1"),
    (r"conv_fusion/conv", "conv_last.0.0"),
    (r"conv_fusion/bn", "conv_last.0.1"),
    (r"conv_last/conv", "conv_last.1"),
)
# the ASPP (either head), relative to its module prefix
_ASPP_RULES = (
    (r"aspp/b([0-3])/conv", r"convs.\1.0"),
    (r"aspp/b([0-3])/bn", r"convs.\1.1"),
    (r"aspp/pool/conv", "convs.4.1"),
    (r"aspp/pool/bn", "convs.4.2"),
    (r"aspp/project/conv", "project.0"),
    (r"aspp/project/bn", "project.1"),
)


def _deeplab_head_rules(aspp: str, fuse: int):
    """A head relative to its module: the ASPP at prefix ``aspp``, the 3x3
    fuse conv and BN at ``classifier.{fuse, fuse + 1}`` and the classifier
    conv at ``fuse + 3``."""
    return tuple((pattern, aspp + repl) for pattern, repl in _ASPP_RULES) + (
        (r"fuse/conv", f"classifier.{fuse}"),
        (r"fuse/bn", f"classifier.{fuse + 1}"),
        (r"classifier/conv", f"classifier.{fuse + 3}"),
    )


# the V3+ head (DeepLabHeadV3Plus): low-level projection, ASPP, then one
# Sequential of fuse and classifier
_DEEPLAB_V3PLUS_RULES = (
    (r"project/conv", "project.0"),
    (r"project/bn", "project.1"),
) + _deeplab_head_rules("aspp.", 0)
# the V3 head (DeepLabHead): one Sequential, ASPP at index 0
_DEEPLAB_V3_RULES = _deeplab_head_rules("classifier.0.", 1)
_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


def _prefixed(prefix: str, repl):
    """A rule's replacement (a template or a function of the match) with
    ``prefix`` in front."""
    if callable(repl):
        return lambda m: prefix + repl(m)
    return prefix + repl


def _torch_prefix(module_path: str, rules) -> str:
    for pattern, repl in rules:
        if re.fullmatch(pattern, module_path):
            return re.sub(pattern, repl, module_path)
    raise KeyError(f"no torch key for flax module {module_path!r}")


def _convert_part(params, batch_stats, rules) -> Dict[str, torch.Tensor]:
    state = {}
    for collection, tree in (("params", params), ("batch_stats",
                                                  batch_stats)):
        for path, value in _flatten(tree):
            module_path, leaf = path.rsplit("/", 1)
            prefix = _torch_prefix(module_path, rules)
            arr = np.asarray(value)
            if arr.dtype.kind in "iu" or "int" in str(arr.dtype):
                arr = arr.astype(np.int8)   # a prequantized int8/int4 kernel
            elif arr.dtype != np.float64:   # float64 stays (tests' trees)
                arr = arr.astype(np.float32)
            if leaf == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))   # HWIO -> OIHW
            state[f"{prefix}.{_LEAVES[(collection, leaf)]}"] = \
                torch.tensor(arr)
            if module_path.endswith("/bn") and leaf == "mean":
                state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return state


def _encoder_rules(params, deeplab: bool = False,
                   mobilenet_style: str = "csail"):
    """The rules of an encoder's flax tree: MobileNet (``net``) or the
    ResNet names, with HRNet's."""
    if "net" in params:
        return _mobilenet_rules(mobilenet_style, deeplab)
    return _ENCODER_RULES + _HRNET_RULES


def state_dict_from_jax(variables) -> Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor]]:
    """flax variables of a SegmentationModel -> (encoder, decoder) torch
    state dicts for ``model.encoder`` / ``model.decoder``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    enc = _convert_part(params["encoder"], stats.get("encoder", {}),
                        _encoder_rules(params["encoder"]))
    dec = _convert_part(params["decoder"], stats.get("decoder", {}),
                        _UPERNET_RULES if "conv_fusion" in params["decoder"]
                        else _DECODER_RULES)
    return enc, dec


def _quant_part(tree, rules, prefix: str):
    """The ``quant`` entries under one flax module tree -> {torch conv
    name: {"amax", "w_scale"}}; an entry sits at the module whose ``conv``
    the rules map."""
    state = {}
    for path, value in _flatten(tree):
        module_path, leaf = path.rsplit("/", 1)
        name = prefix + _torch_prefix(module_path + "/conv", rules)
        state.setdefault(name, {})[leaf] = torch.tensor(
            np.asarray(value, np.float32))
    return state


def quant_state_from_jax(variables) -> Dict[str, Dict[str, torch.Tensor]]:
    """The ``quant`` collection of a JAX ``SegmentationModel`` -> the
    port's quant state (``ops.quant.load_quant_state``), names from the
    model's root (``encoder.layer2.0.conv1``, ``decoder.conv_last.0``)."""
    params, quant = variables["params"], variables.get("quant", {})
    state = {}
    if "encoder" in quant:
        state.update(_quant_part(quant["encoder"],
                                 _encoder_rules(params["encoder"]),
                                 "encoder."))
    if "decoder" in quant:
        state.update(_quant_part(
            quant["decoder"], _UPERNET_RULES if "conv_fusion" in
            params["decoder"] else _DECODER_RULES, "decoder."))
    return state


def deeplab_quant_state_from_jax(variables
                                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The ``quant`` collection of a JAX DeepLab model -> the port's quant
    state, names from the model's root (``backbone.layer2.0.conv1``,
    ``classifier.aspp.convs.1.0``)."""
    params, quant = variables["params"], variables.get("quant", {})
    state = {}
    for name, tree in quant.items():
        if name == "backbone":
            rules, prefix = _encoder_rules(params["backbone"], True), \
                "backbone."
        else:
            rules = (_DEEPLAB_V3PLUS_RULES if "project" in params[name]
                     else _DEEPLAB_V3_RULES)
            prefix = "classifier." if name == "head" else name + "."
        state.update(_quant_part(tree, rules, prefix))
    return state


def deeplab_state_dict_from_jax(variables, mobilenet_style="torchvision"
                                ) -> Dict[str, torch.Tensor]:
    """flax variables of a JAX ``DeepLabV3Plus``, ``DeepLabV3PlusEmbedding``
    (numpy arrays, ``backbone`` and ``head``) or
    ``DeepLabV3PlusSelfDistillation`` (``backbone``, ``classifier``,
    ``classifier_1`` ..) -> the port's DeepLab state dict. A V3+ head (it
    has ``project``) or a V3 head is told apart by its parameters; a
    MobileNet backbone's layout follows ``mobilenet_style``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    backbone_rules = tuple(
        (pattern, _prefixed("backbone.", repl))
        for pattern, repl in _encoder_rules(params["backbone"], True,
                                            mobilenet_style))
    state = _convert_part(params["backbone"], stats.get("backbone", {}),
                          backbone_rules)
    for name, head in params.items():
        if name == "backbone":
            continue
        prefix = "classifier." if name == "head" else name + "."
        rules = (_DEEPLAB_V3PLUS_RULES if "project" in head
                 else _DEEPLAB_V3_RULES)
        state.update(_convert_part(
            head, stats.get(name, {}),
            tuple((pattern, prefix + repl) for pattern, repl in rules)))
    return state
