"""The port's quantized segmentation model against the JAX package's, on a
narrow resnet18dilated + ppm_deepsup_embedding twin (BasicBlock ResNet at
output stride 8, one block per stage, planes 8..64, the PPM embedding
decoder at fc_dim 64, 13 classes), fp32 on the CPU.

- calibration: the port's ``amax`` of every conv after calibrating on the
  same two images equals the JAX package's within rtol 1e-5;
- ``prequantize``: from the same weights and JAX's scales, the port's int8
  (int4 under ``w4a8``) weights and ``w_scale`` equal the JAX package's
  prequantized kernels and scales exactly, and under ``int8-3x3`` its 1x1
  convs keep their float weights as the JAX ones do;
- the forward in each of the five quantized modes (``calib``, ``int8``,
  ``int8-3x3``, ``int8-hybrid``, ``w4a8``), with the JAX package's
  weights, prequantized kernels and quant collection carried across
  (``train/convert.py``): pixel argmax equal on at least 99.5 % of pixels
  and dissum maps within 1 % of their range. The int8 conv is exact in
  both packages; the float layers between them sum in another order, and
  an activation that lands on a rounding boundary of the int8 grid may
  round the other way, which the tolerance allows.

``tests/test_torch_quant_bottleneck.py`` holds the same forward on a
Bottleneck twin, ``tests/test_torch_quant_deeplab.py`` holds the DeepLab twin under
``int8-hybrid``.
"""

import jax
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.models.builder import (
    SegmentationModel as JaxSegmentationModel)
from open_world_semantic_segmentation_tpu.models.decoders import (
    PPMDeepsupEmbedding as JaxPPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu.models.resnet import (
    BasicBlock as JaxBasicBlock, Bottleneck as JaxBottleneck,
    ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.ops import quant as jquant
from open_world_semantic_segmentation_tpu_torch.models.builder import (
    SegmentationModel)
from open_world_semantic_segmentation_tpu_torch.models.decoders import (
    PPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.openset.scoring import (
    dissum_conf)
from open_world_semantic_segmentation_tpu_torch.ops import quant
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    quant_state_from_jax, state_dict_from_jax)
from test_torch_model import fill_jax_variables

TWIN = dict(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64), stem="deep",
            output_stride=8)
NUM_CLASS, FC_DIM = 13, 64
# the Bottleneck twin: its last stage puts out 4 x 64 channels
BOTTLENECK = dict(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64), stem="deep",
                  output_stride=8)
BOTTLENECK_FC_DIM = 256
SIZE = (64, 64)
MODES = ("calib", "int8", "int8-3x3", "int8-hybrid", "w4a8")


def jax_twin(mode="off", bottleneck=False):
    block, twin, fc_dim = ((JaxBottleneck, BOTTLENECK, BOTTLENECK_FC_DIM)
                           if bottleneck else (JaxBasicBlock, TWIN, FC_DIM))
    return JaxSegmentationModel(
        encoder=JaxResNet(block=block, quant=mode, **twin),
        decoder=JaxPPMDeepsupEmbedding(num_class=NUM_CLASS, fc_dim=fc_dim,
                                       quant=mode))


def port_twin(mode="off", bottleneck=False):
    block, twin, fc_dim = ((Bottleneck, BOTTLENECK, BOTTLENECK_FC_DIM)
                           if bottleneck else (BasicBlock, TWIN, FC_DIM))
    return SegmentationModel(
        ResNet(block=block, quant=mode, **twin),
        PPMDeepsupEmbedding(num_class=NUM_CLASS, fc_dim=fc_dim,
                            quant=mode)).eval()


def load(model, variables):
    """The JAX tree (float or prequantized) and its quant collection."""
    enc, dec = state_dict_from_jax(variables)
    model.encoder.load_state_dict(enc)
    model.decoder.load_state_dict(dec)
    return quant.load_quant_state(model, quant_state_from_jax(variables))


def _image(seed):
    return np.random.default_rng(seed).standard_normal(
        (1, *SIZE, 3)).astype(np.float32)


def _started(bottleneck=False):
    """The JAX twin's weights, filled from a numpy seed, with the
    embedding's last 1x1 conv scaled to a std of 0.8 (at the seeded scale
    every distance sum clips at 400 and the dissum map is 0/0), calibrated
    by the JAX package on two images."""
    variables = fill_jax_variables(jax_twin(bottleneck=bottleneck),
                                   (1, *SIZE, 3), 7)
    ft = jax.jit(lambda v, img: jax_twin(bottleneck=bottleneck).apply(
        v, img, seg_size=SIZE)["ft"])(variables, _image(1))
    out = variables["params"]["decoder"]["conv_last"]["out"]["conv"]
    scale = np.float32(0.8 / float(np.std(np.asarray(ft))))
    out["kernel"], out["bias"] = out["kernel"] * scale, out["bias"] * scale
    images = [_image(1), _image(2) * 2.0]
    v_cal = jquant.calibrate(jax_twin("calib", bottleneck), dict(variables),
                             images, seg_size=SIZE)
    return variables, v_cal, images


@pytest.fixture(scope="module")
def setup():
    return _started()


@pytest.fixture(scope="module")
def jax_prequantized(setup):
    """The JAX package's prequantized tree of each mode, made once."""
    trees = {}

    def get(mode):
        if mode not in trees:
            trees[mode] = jquant.prequantize(setup[1], mode=mode)
        return trees[mode]
    return get


def _amax_by_name(state):
    return {name: float(e["amax"]) for name, e in state.items()}


def test_calibration_matches_jax(setup):
    variables, v_cal, images = setup
    calib = load(port_twin("calib"), variables)
    got = _amax_by_name(quant.calibrate(calib, images, seg_size=SIZE))
    want = _amax_by_name(quant_state_from_jax(v_cal))
    assert set(got) == set(want) and len(got) > 0
    for name in want:
        assert want[name] > 0, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["int8", "int8-3x3", "int8-hybrid",
                                  "w4a8"])
def test_prequantize_matches_jax(setup, jax_prequantized, mode):
    variables, v_cal, _ = setup
    model = load(port_twin(mode), variables)
    quant.prequantize(model, quant_state_from_jax(v_cal), mode=mode)
    v_pre = jax_prequantized(mode)
    enc, dec = state_dict_from_jax(v_pre)
    want = {**{"encoder." + k: v for k, v in enc.items()},
            **{"decoder." + k: v for k, v in dec.items()}}
    got = model.state_dict()
    n_int = 0
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        n_int += value.dtype == torch.int8
        torch.testing.assert_close(got[key], value, rtol=0, atol=0,
                                   msg=key)
    assert n_int > 0
    scales = quant_state_from_jax(v_pre)
    for name, entry in scales.items():
        if "w_scale" in entry:
            torch.testing.assert_close(model.get_submodule(name).w_scale,
                                       entry["w_scale"], rtol=0, atol=0)


def _forward_matches_jax(variables, v_q, mode, bottleneck=False):
    x = _image(3)
    want = np.asarray(jax.jit(
        lambda v, img: jax_twin(mode, bottleneck).apply(
            v, img, seg_size=SIZE, mutable=["quant"])[0]["scores"]
    )(v_q, x), np.float32)
    model = load(port_twin(mode, bottleneck), v_q)
    with torch.no_grad():
        got = model(torch.from_numpy(x), seg_size=SIZE)["scores"]
    assert (got.argmax(-1).numpy() == want.argmax(-1)).mean() >= 0.995
    conf = dissum_conf(got[0]).numpy()
    conf_jax = dissum_conf(torch.from_numpy(want[0].copy())).numpy()
    assert np.isfinite(conf).all() and conf.min() < conf.max()
    span = conf_jax.max() - conf_jax.min()
    assert np.abs(conf - conf_jax).max() <= 0.01 * span
    if mode != "calib":
        # the quantized convs ran: the float forward differs
        with torch.no_grad():
            ref = load(port_twin(bottleneck=bottleneck), variables)(
                torch.from_numpy(x), seg_size=SIZE)["scores"]
        assert not torch.equal(ref, got)


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(setup, jax_prequantized, mode):
    variables, v_cal, _ = setup
    if mode == "calib":
        v_q = variables
    elif mode == "w4a8":
        v_q = v_cal      # int4 weights quantized inline in both
    else:
        v_q = jax_prequantized(mode)
    _forward_matches_jax(variables, v_q, mode)
