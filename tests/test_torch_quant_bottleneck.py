"""The port's quantized segmentation model against the JAX package's on a
narrow Bottleneck twin (the flagship resnet50dilated's block: output
stride 8, one block a stage, planes 8..64, the PPM embedding decoder at
fc_dim 256, 13 classes), fp32 on the CPU, in the four eval modes, where
``int8-3x3`` leaves each block's two 1x1 convs in float: the JAX
package's weights, prequantized kernels and quant collection carried
across, pixel argmax equal on at least 99.5 % of pixels and dissum maps
within 1 % of their range (``tests/test_torch_quant_model.py`` has the
BasicBlock twin and the reasons for the tolerance).
"""

import pytest

from open_world_semantic_segmentation_tpu.ops import quant as jquant
from test_torch_quant_model import _forward_matches_jax, _started


@pytest.fixture(scope="module")
def setup():
    return _started(bottleneck=True)


@pytest.mark.parametrize("mode", ["int8", "int8-3x3", "int8-hybrid",
                                  "w4a8"])
def test_bottleneck_forward_matches_jax(setup, mode):
    variables, v_cal, _ = setup
    v_q = v_cal if mode == "w4a8" else jquant.prequantize(v_cal, mode=mode)
    _forward_matches_jax(variables, v_q, mode, bottleneck=True)
