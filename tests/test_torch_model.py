"""The port's segmentation model vs the JAX package's, with the same weights.

A shallow, narrow twin of the eval model (deep-stem Bottleneck ResNet at
output stride 8, one block per stage, planes 8..64; PPM embedding decoder
with 13 classes and fc_dim 256). The JAX model's variable tree is filled
from a numpy seed (BN statistics included, so BN is not the identity),
carried into the port through ``state_dict_from_jax``, and both forwards
run in fp32 on the CPU.

Tolerances: scores rtol 1e-4 of their largest magnitude (fp32 convs summed
in another order over ~20 layers); the argmax must agree on >= 99.9 % of
pixels (random logits can tie to within that rounding).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from open_world_semantic_segmentation_tpu.models.builder import (
    SegmentationModel as JaxSegmentationModel)
from open_world_semantic_segmentation_tpu.models.decoders import (
    PPMDeepsupEmbedding as JaxPPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu.models.resnet import (
    BasicBlock as JaxBasicBlock, Bottleneck as JaxBottleneck,
    ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.train.convert import (
    convert_segmentation_model)
from open_world_semantic_segmentation_tpu_torch.models.builder import (
    SegmentationModel, init_weights)
from open_world_semantic_segmentation_tpu_torch.models.decoders import (
    PPMDeepsupEmbedding)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    state_dict_from_jax)

TWIN = dict(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64), stem="deep",
            output_stride=8)
NUM_CLASS, FC_DIM = 13, 256


def jax_twin():
    return JaxSegmentationModel(
        encoder=JaxResNet(block=JaxBottleneck, **TWIN),
        decoder=JaxPPMDeepsupEmbedding(num_class=NUM_CLASS, fc_dim=FC_DIM))


def port_twin(fused_blocks=False):
    return SegmentationModel(
        ResNet(block=Bottleneck, fused_blocks=fused_blocks, **TWIN),
        PPMDeepsupEmbedding(num_class=NUM_CLASS, fc_dim=FC_DIM)).eval()


def jax_twin_variables(seed=0):
    """The JAX twin's variable tree, filled from a numpy seed."""
    return fill_jax_variables(jax_twin(), (1, 64, 64, 3), seed)


def jax_variable_shapes(module, input_shape):
    """``module``'s variable tree as shapes, from ``init``."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.zeros(input_shape))


def fill_jax_variables(module, input_shape, seed, shapes=None):
    """``module``'s variable tree (``shapes``, else the shapes from
    ``init``), filled from a numpy seed: kernels he-normal over fan_in, BN
    scale/bias/mean/var random around the identity."""
    if shapes is None:
        shapes = jax_variable_shapes(module, input_shape)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:   # bias, mean
            v = rng.standard_normal(shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_twin_apply(variables, x, seg_size):
    """One jitted program: eager flax compiles op by op, ~10x slower."""
    return jax.jit(jax_twin().apply, static_argnames="seg_size")(
        variables, jnp.asarray(x), seg_size=seg_size)


def port_twin_from(variables, fused_blocks=False):
    model = port_twin(fused_blocks)
    enc, dec = state_dict_from_jax(variables)
    model.encoder.load_state_dict(enc)
    model.decoder.load_state_dict(dec)
    return model


def _image(seed, size=(64, 64)):
    return np.random.default_rng(seed).standard_normal(
        (1, *size, 3)).astype(np.float32)


def _assert_scores_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_eval_forward_matches_jax():
    variables = jax_twin_variables()
    x = _image(1)
    want = jax_twin_apply(variables, x, seg_size=(64, 64))
    with torch.no_grad():
        got = port_twin_from(variables)(torch.from_numpy(x),
                                        seg_size=(64, 64))
    assert set(got) == set(want) == {"scores", "ft"}
    for key in ("scores", "ft"):
        assert got[key].shape == want[key].shape
        _assert_scores_close(got[key].numpy(), np.asarray(want[key]))
    same = (got["scores"].numpy().argmax(-1)
            == np.asarray(want["scores"]).argmax(-1)).mean()
    assert same >= 0.999


@pytest.mark.parametrize("size", [(64, 64), (50, 70)])
def test_eval_forward_fused_blocks_matches_jax(size):
    """The port twin with ``fused_blocks=True`` (every stride-1 bottleneck
    through ``ops/fused_block.py``, its plain version on the CPU) against
    the JAX twin; (50, 70) gives maps that do not fill the kernel's 8x8
    tiles."""
    variables = jax_twin_variables()
    x = _image(2, size)
    want = jax_twin_apply(variables, x, seg_size=size)
    model = port_twin_from(variables, fused_blocks=True)
    routed = [name for name, m in model.encoder.named_modules()
              if isinstance(m, Bottleneck) and m.fused_tile is not None]
    assert routed == ["layer1.0", "layer3.0", "layer4.0"]  # not strided 2.0
    with torch.no_grad():
        got = model(torch.from_numpy(x), seg_size=size)
    for key in ("scores", "ft"):
        _assert_scores_close(got[key].numpy(), np.asarray(want[key]))
    same = (got["scores"].numpy().argmax(-1)
            == np.asarray(want["scores"]).argmax(-1)).mean()
    assert same >= 0.999


def test_fused_route_folds_once_and_follows_parameters():
    """The folded weights are cached per dtype and device, and dropped
    when the parameters may change (train(), load_state_dict)."""
    model = port_twin_from(jax_twin_variables(), fused_blocks=True)
    block = model.encoder.layer1[0]
    x = torch.from_numpy(_image(3))
    with torch.no_grad():
        model(x, seg_size=(64, 64))
        folded = block._folded[(torch.float32, torch.device("cpu"))]
        model(x, seg_size=(64, 64))
        assert block._folded[(torch.float32, torch.device("cpu"))] is folded
        model.train()
        assert block._folded == {}
        model.eval()(x, seg_size=(64, 64))
        model.encoder.load_state_dict(model.encoder.state_dict())
        assert block._folded == {}


@pytest.mark.parametrize("stride,first_dilation,dilation",
                         [(2, 1, 1), (1, 1, 2), (1, 2, 4)])
def test_basic_block_matches_jax(stride, first_dilation, dilation):
    """BasicBlock (not in resnet50): one block with a downsample, its
    weights carried by state_dict_from_jax as block 0 of layer1."""
    jax_block = JaxBasicBlock(planes=8, stride=stride, dilation=dilation,
                              first_dilation=first_dilation, downsample=True)
    variables = fill_jax_variables(jax_block, (1, 17, 20, 4), stride)
    enc, _ = state_dict_from_jax({
        "params": {"encoder": {"layer1_0": variables["params"]},
                   "decoder": {}},
        "batch_stats": {"encoder": {"layer1_0": variables["batch_stats"]}}})
    block = BasicBlock(4, 8, stride, dilation, first_dilation,
                       downsample=True).eval()
    block.load_state_dict({k[len("layer1.0."):]: v for k, v in enc.items()})
    x = np.random.default_rng(0).standard_normal((1, 17, 20, 4)).astype(
        np.float32)
    want = jax.jit(jax_block.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    _assert_scores_close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_state_dict_roundtrip_through_jax_converter():
    """port state dict -> JAX train/convert.py -> state_dict_from_jax gives
    back the same tensors, key for key."""
    model = init_weights(port_twin(), torch.Generator().manual_seed(0))
    with torch.no_grad():   # non-trivial BN statistics
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    enc0 = model.encoder.state_dict()
    dec0 = model.decoder.state_dict()
    variables = convert_segmentation_model(
        {k: v.numpy() for k, v in enc0.items()},
        {k: v.numpy() for k, v in dec0.items()})
    enc1, dec1 = state_dict_from_jax(variables)
    for before, after in ((enc0, enc1), (dec0, dec1)):
        assert set(before) == set(after)
        for key in before:
            torch.testing.assert_close(after[key], before[key], rtol=0,
                                       atol=0, check_dtype=False)
