"""The port's int8 PTQ primitives (``ops/quant.py``) against the JAX
package's, and the quantized models' structure.

- the quantizers: ``quantize_weight``, ``quantize_weight_int4`` and
  ``quantize_act`` give the JAX package's integers and scales exactly
  (tolerance 0; the port's OIHW kernels are the JAX HWIO ones
  transposed); an uncalibrated ``amax`` gives a NaN scale in both;
- the exact int8 conv: the port's plain version (a float64 conv of the
  integers) and its ``_int_mm`` tap form, run here on the CPU, equal the
  JAX package's ``conv_general_dilated(..., preferred_element_type=int32)``
  bit for bit at 1x1, 3x3, stride 2, dilations 2, 4 and 12, 32 groups and
  a 3-channel input;
- ``prequantize`` refuses a missing or uncalibrated state and leaves the
  1x1 convs in float under ``int8-3x3``;
- a model's parameter keys are the same in every mode, a float checkpoint
  loads into each, and a prequantized one keeps its int8 weights;
- ``ModelBuilder`` refuses what the JAX package's refuses
  (``tests/test_quant.py``), and ``fused_blocks`` with quant; the DeepLab
  factories split ``int8-hybrid`` as the JAX package's ``_split_quant``.

The JAX side is jitted per geometry (a few tiny compiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.ops import quant as jquant
from open_world_semantic_segmentation_tpu_torch.models import deeplab
from open_world_semantic_segmentation_tpu_torch.models.builder import (
    ModelBuilder, init_weights)
from open_world_semantic_segmentation_tpu_torch.models.layers import (
    QuantConv2d)
from open_world_semantic_segmentation_tpu_torch.ops import quant

MODES = ("calib", "int8", "int8-3x3", "int8-hybrid", "w4a8")


def _weights(seed, shape=(3, 3, 8, 6)):
    """HWIO float32 weights with per-channel magnitudes 100x apart."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 1] *= 100.0
    w[..., 2] *= 0.01
    return w


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("name", ["quantize_weight", "quantize_weight_int4"])
def test_weight_quantizers_match_jax(name):
    w = _weights(0)
    jq, js = getattr(jquant, name)(jnp.asarray(w))
    q, s = getattr(quant, name)(_oihw(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jq, np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_act_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 3)).astype(
        np.float32) * 3
    for amax in (4.0, 1.7, float(np.abs(x).max())):
        jq, js = jquant.quantize_act(jnp.asarray(x), jnp.float32(amax))
        q, s = quant.quantize_act(torch.from_numpy(x), torch.tensor(amax))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the JAX package's own example: amax 4 saturates 10 at 127
    q, s = quant.quantize_act(torch.tensor([[0.5, -2.0, 10.0]]),
                              torch.tensor(4.0))
    np.testing.assert_array_equal(q.numpy(), [[16, -64, 127]])


def test_uncalibrated_scale_is_nan():
    _, js = jquant.quantize_act(jnp.ones((2, 2)), jnp.float32(0.0))
    _, s = quant.quantize_act(torch.ones(2, 2), torch.tensor(0.0))
    assert np.isnan(float(js)) and torch.isnan(s)


# (N, Cin, H, W, Cout, kernel, stride, padding, dilation, groups)
CONVS = {
    "1x1": (2, 16, 9, 11, 24, 1, 1, 0, 1, 1),
    "3x3": (1, 12, 10, 9, 10, 3, 1, 1, 1, 1),
    "stride2": (1, 16, 11, 12, 8, 3, 2, 1, 1, 1),
    "dilation2": (1, 8, 12, 13, 8, 3, 1, 2, 2, 1),
    "dilation4": (1, 8, 14, 12, 16, 3, 1, 4, 4, 1),
    "dilation12": (1, 16, 13, 20, 8, 3, 1, 12, 12, 1),
    "groups32": (1, 64, 8, 9, 64, 3, 2, 1, 1, 32),
    "cin3": (1, 3, 16, 16, 8, 3, 2, 1, 1, 1),
    "1x1_map": (1, 40, 1, 1, 24, 1, 1, 0, 1, 1),
}


@pytest.mark.parametrize("geom", list(CONVS), ids=list(CONVS))
def test_int8_conv_exact_against_jax(geom):
    n, cin, h, w, cout, k, s, p, d, g = CONVS[geom]
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8)
    wt = rng.integers(-127, 128, (k, k, cin // g, cout), dtype=np.int8)
    want = np.asarray(jax.jit(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (s, s), ((p, p), (p, p)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g,
        preferred_element_type=jnp.int32))(x, wt))
    xq = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    wq = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    for fn in (quant.int8_conv2d, quant.int8_conv2d_plain,
               quant.int8_conv2d_taps):
        got = fn(xq, wq, s, p, d, g)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_int8_conv_refuses_float():
    with pytest.raises(TypeError, match="int8"):
        quant.int8_conv2d(torch.ones(1, 8, 4, 4), torch.ones(8, 8, 1, 1,
                                                             dtype=torch.int8))


def _tiny(quant_mode="off", **kw):
    model = ModelBuilder.build_segmentation_model(
        "resnet18dilated", "ppm_deepsup_embedding", 13, quant=quant_mode,
        **kw)
    return model


@pytest.fixture(scope="module")
def float_state():
    model = _tiny()
    init_weights(model, torch.Generator().manual_seed(0))
    return model.state_dict()


def test_state_dict_keys_same_in_every_mode(float_state):
    """A quant-off checkpoint loads (strictly) into every mode: the conv
    parameters keep their keys, ``amax`` / ``w_scale`` are not in them."""
    for mode in MODES:
        model = _tiny(mode)
        assert set(model.state_dict()) == set(float_state), mode
        model.load_state_dict(float_state)
        convs = [m for m in model.modules() if isinstance(m, QuantConv2d)]
        assert convs, mode
        assert all(m.amax.item() == 0.0 for m in convs)


def test_prequantize_refusals_and_int8_3x3(float_state):
    model = _tiny("int8-3x3")
    model.load_state_dict(float_state)
    with pytest.raises(ValueError, match="calibrate"):
        quant.prequantize(model, {}, mode="int8-3x3")
    calib = _tiny("calib")
    calib.load_state_dict(float_state)
    state = quant.quant_state(calib)
    with pytest.raises(ValueError, match="amax is 0"):
        quant.prequantize(model, state, mode="int8-3x3")
    state = quant.calibrate(calib, [np.random.default_rng(0).standard_normal(
        (1, 32, 32, 3)).astype(np.float32)], seg_size=(32, 32))
    assert all(e["amax"] > 0 for e in state.values())
    quant.prequantize(model, state, mode="int8-3x3")
    for name in state:
        m = model.get_submodule(name)
        one = tuple(m.kernel_size) == (1, 1)
        assert m.weight.dtype == (torch.float32 if one else torch.int8), name
        assert isinstance(m, QuantConv2d) != one, name


def test_prequantized_checkpoint_keeps_int8(float_state):
    """A prequantized model's state dict loads its int8 weights as int8;
    with the quant state beside it the forward is the same."""
    calib = _tiny("calib")
    calib.load_state_dict(float_state)
    img = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    state = quant.calibrate(calib, [img], seg_size=(32, 32))
    model = _tiny("int8")
    model.load_state_dict(float_state)
    quant.prequantize(model, state, mode="int8")
    saved = quant.quant_state(model)
    again = _tiny("int8")
    again.load_state_dict(model.state_dict())
    quant.load_quant_state(again, saved)
    n_int8 = sum(p.dtype == torch.int8 for p in again.parameters())
    assert n_int8 == len(state) > 0
    x = torch.from_numpy(img)
    with torch.no_grad():
        a = model(x, seg_size=(32, 32))["scores"]
        b = again(x, seg_size=(32, 32))["scores"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_builder_refusals():
    """The JAX package's (tests/test_quant.py), and fused_blocks."""
    with pytest.raises(ValueError, match="inference-only"):
        _tiny("int8", train=True)
    with pytest.raises(ValueError, match="ResNet/ResNeXt"):
        ModelBuilder.build_encoder("hrnetv2", quant="int8")
    with pytest.raises(ValueError, match="ResNet/ResNeXt"):
        ModelBuilder.build_encoder("mobilenetv2dilated", quant="int8")
    with pytest.raises(ValueError, match="PPM decoder"):
        ModelBuilder.build_decoder("c1", quant="int8")
    with pytest.raises(ValueError, match="fused"):
        ModelBuilder.build_encoder("resnet50dilated", quant="int8",
                                   fused_blocks=True)
    with pytest.raises(ValueError, match="quant"):
        ModelBuilder.build_encoder("resnet18dilated", quant="int4")


def test_quant_stages():
    """Default: layers 2-4 (0-based 1-3); the stem and layer1 in float."""
    def quantized(enc):
        return {n.split(".")[0] for n, m in enc.named_modules()
                if isinstance(m, QuantConv2d)}

    enc = ModelBuilder.build_encoder("resnet18dilated", quant="int8")
    assert quantized(enc) == {"layer2", "layer3", "layer4"}
    enc = ModelBuilder.build_encoder("resnext101", quant="int8",
                                     quant_stages=(0, 1, 2, 3))
    assert quantized(enc) == {"layer1", "layer2", "layer3", "layer4"}


def test_deeplab_factories_split_quant():
    """int8-hybrid: an int8 backbone under a float head (the JAX
    ``_split_quant``); int8: both, but the 1x1 classifier and the ASPP's
    image pool; the factories without the JAX ``quant`` refuse it."""
    def quantized(model, part):
        return [n for n, m in getattr(model, part).named_modules()
                if isinstance(m, QuantConv2d)]

    with torch.device("meta"):
        hybrid = deeplab.deeplabv3plus_embedding_resnet50(
            quant="int8-hybrid")
        full = deeplab.deeplabv3plus_resnet101(quant="int8")
        calib = deeplab.deeplabv3plus_embedding_resnet101(
            quant="calib-hybrid")
    assert quantized(hybrid, "backbone") and not quantized(hybrid,
                                                           "classifier")
    assert {m.mode for m in calib.modules()
            if isinstance(m, QuantConv2d)} == {"calib"}
    assert not quantized(calib, "classifier")
    assert sorted(quantized(full, "classifier")) == [
        "aspp.convs.0.0", "aspp.convs.1.0", "aspp.convs.2.0",
        "aspp.convs.3.0", "aspp.project.0", "classifier.0", "project.0"]
    for factory in ("deeplabv3plus_resnet50", "deeplabv3_resnet101",
                    "deeplabv3plus_mobilenet",
                    "deeplabv3plus_embedding_self_distillation_resnet101"):
        for mode in ("int8-hybrid", "calib-hybrid", "int8"):
            with pytest.raises(TypeError, match="quant"):
                getattr(deeplab, factory)(quant=mode)
