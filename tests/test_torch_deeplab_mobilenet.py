"""The MobileNet DeepLab factories in the port against the JAX package's:
``deeplabv3plus_mobilenet``, ``deeplabv3_mobilenet`` and
``deeplabv3plus_embedding_mobilenet`` (OS16, ASPP rates 6, 12, 18; the
embedding model against the JAX V3+ model's output, which is its
features) with the
reference's torchvision-style MobileNetV2 (stem padding 0, each block's
input padded before its expand conv), and the V3+ model on the CSAIL-style
one (stem and depthwise convs padded). The JAX twin's variables are filled
from a numpy seed and carried into the port through
``deeplab_state_dict_from_jax``; both forwards run in fp32 on the CPU on a
seeded 1x32x64 image. The torchvision-style V3+ state dicts also go
through the JAX package's reader of the reference's checkpoints
(``convert_mobilenet_deeplab_checkpoint``, which reads V3+ heads only) and
back to the same keys and values.

Tolerance: the logits (and the embedding's features) within 1e-4 of the
largest magnitude; the argmax equal on at least 99.9 % of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.models import deeplab as jdeeplab
from open_world_semantic_segmentation_tpu.models.mobilenet import (
    mobilenet_v2 as jax_mobilenet_v2)
from open_world_semantic_segmentation_tpu.ops.distance import (
    one_hot_center_logits)
from open_world_semantic_segmentation_tpu.train.convert import (
    convert_mobilenet_deeplab_checkpoint)
from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.models import deeplab
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    deeplab_state_dict_from_jax)
from test_torch_model import fill_jax_variables

NUM_CLASSES = 16
INPUT = (1, 32, 64, 3)
CASES = [("deeplabv3plus_mobilenet", "torchvision"),
         ("deeplabv3_mobilenet", "torchvision"),
         ("deeplabv3plus_mobilenet", "csail")]


def _jax_model(name, style):
    if style == "torchvision":
        return getattr(jdeeplab, name)(NUM_CLASSES, output_stride=16)
    return jdeeplab.DeepLabV3Plus(
        backbone=jax_mobilenet_v2(output_stride=16, style=style,
                                  name="backbone"),
        head=jdeeplab.DeepLabHeadV3Plus(NUM_CLASSES, (6, 12, 18),
                                        name="head"))


def _check(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def _roundtrip(model):
    """The state dict through the JAX package's reader and back."""
    flax = convert_mobilenet_deeplab_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()})
    back = deeplab_state_dict_from_jax(flax)
    sd = model.state_dict()
    keys = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert {k for k in back if not k.endswith("num_batches_tracked")} == keys
    for key in keys:
        np.testing.assert_array_equal(back[key].numpy(), sd[key].numpy(),
                                      err_msg=key)


@pytest.mark.parametrize("name,style", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_mobilenet_factory_matches_jax(name, style):
    """The factory's logits against the JAX one's. The V3+ case also holds
    ``deeplabv3plus_embedding_mobilenet`` on the same weights: the JAX V3+
    model's output is the embedding wrapper's features (the same backbone
    and head, upsampled), and its logits are their distance to the one-hot
    centres (the JAX ``one_hot_center_logits``)."""
    jax_model = _jax_model(name, style)
    seed = CASES.index((name, style))
    variables = fill_jax_variables(jax_model, INPUT, seed)
    x = np.random.default_rng(10 + seed).standard_normal(INPUT).astype(
        np.float32)
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x))

    model = getattr(deeplab, name)(NUM_CLASSES, 16, style=style).eval()
    state = deeplab_state_dict_from_jax(variables, mobilenet_style=style)
    model.load_state_dict(state)
    with torch.no_grad():
        _check(model(torch.from_numpy(x)), want)
    if style == "torchvision" and name == "deeplabv3plus_mobilenet":
        _roundtrip(model)
        emb = deeplab.deeplabv3plus_embedding_mobilenet(NUM_CLASSES,
                                                        16).eval()
        emb.load_state_dict(state)
        with torch.no_grad():
            logits, centers, features = emb(torch.from_numpy(x))
        _check(features, want)
        _check(logits, jax.jit(one_hot_center_logits)(want, 3.0))
        _roundtrip(emb)


def test_main_deeplab_builds_the_mobilenet_factories():
    cfg = load_config("configs/cityscapes_embedding.yaml")
    for name in ("deeplabv3plus_mobilenet", "deeplabv3_mobilenet",
                 "deeplabv3plus_embedding_mobilenet"):
        cfg.DEEPLAB.model = name
        with torch.device("meta"):
            model, _ = main_deeplab.build_model(cfg)
        assert "backbone.high_level_features.17.conv.3.weight" in \
            model.state_dict()
        with pytest.raises(ValueError, match="fused_blocks"):
            main_deeplab.build_model(cfg, fused_blocks=True)
