"""The port's DeepLab model under ``int8-hybrid`` against the JAX
package's, on the narrow twin of ``test_torch_deeplab.py`` (7x7 stem,
Bottleneck layers (1, 1, 2, 1), planes 8..64, output stride 16, the V3+
embedding head with 16 classes and ASPP rates 6, 12, 18), fp32 on the CPU.

``int8-hybrid`` on DeepLab is an int8 backbone under a float head (the
JAX package's ``_split_quant``), calibrated by its ``calib-hybrid`` twin:

- the JAX package's calibrated and prequantized tree has scales in the
  backbone alone and float head kernels (its ``tests/test_quant.py``), and
  the port's own calibration and ``prequantize`` from the same weights
  give the same int8 weights and scales;
- with that tree carried across (``train/convert.py``), the forward's
  argmax is equal on at least 99.5 % of pixels and the logits lie within
  1 % of their largest magnitude of the JAX package's.
"""

import jax
import numpy as np
import torch

from open_world_semantic_segmentation_tpu.models import deeplab as jdeeplab
from open_world_semantic_segmentation_tpu.models.resnet import (
    Bottleneck as JaxBottleneck, ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.ops import quant as jquant
from open_world_semantic_segmentation_tpu_torch.models import deeplab
from open_world_semantic_segmentation_tpu_torch.models.layers import (
    BNConfig, QuantConv2d)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.ops import quant
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    deeplab_quant_state_from_jax, deeplab_state_dict_from_jax)
from test_torch_model import fill_jax_variables

TWIN = dict(layers=(1, 1, 2, 1), planes=(8, 16, 32, 64), stem="7x7",
            output_stride=16)
NUM_CLASSES, RATES = 16, (6, 12, 18)
INPUT = (1, 64, 128, 3)


def jax_twin(quant_mode="off"):
    bq, hq = jdeeplab._split_quant(quant_mode)
    return jdeeplab.DeepLabV3PlusEmbedding(
        backbone=JaxResNet(block=JaxBottleneck, quant=bq, name="backbone",
                           **TWIN),
        head=jdeeplab.DeepLabHeadV3Plus(NUM_CLASSES, RATES, quant=hq,
                                        name="head"))


def port_twin(quant_mode="off"):
    bq, hq = deeplab._split_quant(quant_mode)
    backbone = ResNet(block=Bottleneck, bn=BNConfig(momentum=0.01),
                      quant=bq, **TWIN)
    head = deeplab.DeepLabHeadV3Plus(256, 32, NUM_CLASSES, RATES, quant=hq)
    return deeplab.DeepLabV3PlusEmbedding(backbone, head).eval()


def _load(model, variables):
    model.load_state_dict(deeplab_state_dict_from_jax(variables))
    return quant.load_quant_state(model,
                                  deeplab_quant_state_from_jax(variables))


def test_int8_hybrid_matches_jax():
    variables = fill_jax_variables(jax_twin(), INPUT, 0)
    rng = np.random.default_rng(1)
    calib_imgs = [rng.standard_normal(INPUT).astype(np.float32)
                  for _ in range(2)]
    x = rng.standard_normal(INPUT).astype(np.float32)
    v_q = jquant.calibrate_and_prequantize(
        jax_twin("calib-hybrid"), dict(variables), calib_imgs,
        mode="int8-hybrid")
    assert "backbone" in v_q["quant"] and "head" not in v_q["quant"]
    head_dtypes = {leaf.dtype for leaf in
                   jax.tree_util.tree_leaves(v_q["params"]["head"])}
    assert np.dtype(np.int8) not in head_dtypes

    # the port's own calibration and prequantization from the same weights
    model = _load(port_twin("int8-hybrid"), variables)
    calib = _load(port_twin("calib-hybrid"), variables)
    quant.calibrate_and_prequantize(calib, model, calib_imgs,
                                    mode="int8-hybrid")
    assert not [n for n, m in model.classifier.named_modules()
                if isinstance(m, QuantConv2d)]
    want_sd = deeplab_state_dict_from_jax(v_q)
    got_sd = model.state_dict()
    n_int8 = 0
    for key, value in want_sd.items():
        assert got_sd[key].dtype == value.dtype, key
        n_int8 += value.dtype == torch.int8
        torch.testing.assert_close(got_sd[key], value, rtol=0, atol=0,
                                   msg=key)
    assert n_int8 > 0
    for name, entry in deeplab_quant_state_from_jax(v_q).items():
        assert name.startswith("backbone."), name
        m = model.get_submodule(name)
        np.testing.assert_allclose(float(m.amax), float(entry["amax"]),
                                   rtol=1e-5, err_msg=name)
        torch.testing.assert_close(m.w_scale, entry["w_scale"], rtol=0,
                                   atol=0)

    # the forward with the JAX package's tree carried across
    want = np.asarray(jax.jit(jax_twin("int8-hybrid").apply)(v_q, x)[0])
    with torch.no_grad():
        got = _load(port_twin("int8-hybrid"), v_q)(torch.from_numpy(x))[0]
    got = got.numpy()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.995
    assert np.abs(got - want).max() <= 0.01 * np.abs(want).max()
