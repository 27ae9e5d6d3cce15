"""The port's DeepLab models against the JAX package's, with the same
weights.

A narrow twin of deeplabv3plus_embedding_resnet101: the torchvision 7x7
stem, Bottleneck layers (1, 1, 2, 1) with planes 8..64 at output stride 16
(so layer1.0 takes the stem's 64 channels, and layer3.1 and layer4.0 are
stride-1 blocks the fused route takes), and the V3+ head with 16 classes
and ASPP rates (6, 12, 18). The JAX twin's variables are filled from a
numpy seed (BN statistics included), carried into the port through
``train/convert.py deeplab_state_dict_from_jax``, and both forwards run in
fp32 on the CPU on a seeded 1x64x128 image. The JAX side runs its default
dataflows (the per-branch ASPP projection, the shift-dilated convs); the
ASPP alone is also held against its concat dataflow
(``OWSS_ASPP_PROJECT=concat``, read in this process only).

Tolerance: logits, centers and features within 1e-4 of the largest
magnitude (fp32 convs summed in another order over ~20 layers); the argmax
must be equal.
"""

import pickletools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.models import deeplab as jdeeplab
from open_world_semantic_segmentation_tpu.models.resnet import (
    Bottleneck as JaxBottleneck, ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.ops import pool as jpool
from open_world_semantic_segmentation_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from open_world_semantic_segmentation_tpu.train.convert import (
    convert_deeplab_checkpoint)
from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
from open_world_semantic_segmentation_tpu_torch.models import deeplab
from open_world_semantic_segmentation_tpu_torch.models.layers import BNConfig
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.ops import pool
from open_world_semantic_segmentation_tpu_torch.train.checkpoint import (
    load_deeplab_state)
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    deeplab_state_dict_from_jax)
from test_torch_model import fill_jax_variables

TWIN = dict(layers=(1, 1, 2, 1), planes=(8, 16, 32, 64), stem="7x7",
            output_stride=16)
NUM_CLASSES, RATES = 16, (6, 12, 18)
INPUT = (1, 64, 128, 3)


def jax_twin(head=jdeeplab.DeepLabHeadV3Plus,
             wrapper=jdeeplab.DeepLabV3PlusEmbedding):
    return wrapper(
        backbone=JaxResNet(block=JaxBottleneck, name="backbone", **TWIN),
        head=head(NUM_CLASSES, RATES, name="head"))


def port_twin(fused_blocks=False, v3plus=True,
              wrapper=deeplab.DeepLabV3PlusEmbedding):
    backbone = ResNet(block=Bottleneck, fused_blocks=fused_blocks,
                      bn=BNConfig(momentum=0.01), **TWIN)
    head = (deeplab.DeepLabHeadV3Plus(256, 32, NUM_CLASSES, RATES) if v3plus
            else deeplab.DeepLabHead(256, NUM_CLASSES, RATES))
    return wrapper(backbone, head).eval()


def twin_variables(seed=0, input_shape=INPUT):
    return fill_jax_variables(jax_twin(), input_shape, seed)


def port_twin_from(variables, fused_blocks=False):
    model = port_twin(fused_blocks)
    model.load_state_dict(deeplab_state_dict_from_jax(variables))
    return model


def _image(seed=1, shape=INPUT):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def jax_outputs():
    variables = twin_variables()
    x = _image()
    out = jax.jit(jax_twin().apply)(variables, jnp.asarray(x))
    return variables, x, [np.asarray(o) for o in out]


@pytest.mark.parametrize("fused_blocks", [False, True],
                         ids=["unfused", "fused"])
def test_embedding_twin_matches_jax(jax_outputs, fused_blocks):
    """Logits, centers and features of the port twin against the JAX twin;
    with ``fused_blocks`` the stride-1 bottlenecks take the fused route
    (its plain version on the CPU)."""
    variables, x, want = jax_outputs
    model = port_twin_from(variables, fused_blocks)
    routed = [name for name, m in model.backbone.named_modules()
              if isinstance(m, Bottleneck) and m.fused_tile is not None]
    assert routed == (["layer1.0", "layer3.1", "layer4.0"] if fused_blocks
                      else [])
    with torch.no_grad():
        got = [o.numpy() for o in model(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _assert_close(g, w)
    assert want[0].shape == (1, 64, 128, NUM_CLASSES)
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


@pytest.mark.parametrize("dataflow", ["sum", "concat"])
def test_aspp_matches_both_jax_dataflows(monkeypatch, dataflow):
    """The port's ASPP (concat, then the 1x1 projection) against the JAX
    ASPP's default per-branch projection sum and its concat dataflow; the
    3x3 convs at rate >= 6 take the JAX shift-dilated path in both."""
    monkeypatch.setenv("OWSS_ASPP_PROJECT", dataflow)
    jax_aspp = jdeeplab.ASPP(RATES)
    shape = (2, 9, 13, 24)
    variables = fill_jax_variables(jax_aspp, shape, 3)
    x = _image(4, shape)
    want = np.asarray(jax.jit(jax_aspp.apply)(variables, jnp.asarray(x)))
    state = deeplab_state_dict_from_jax({
        "params": {"backbone": {}, "head": {
            "project": {}, "aspp": variables["params"]}},
        "batch_stats": {"head": {"aspp": variables["batch_stats"]}}})
    aspp = deeplab.ASPP(24, RATES).eval()
    aspp.load_state_dict({k[len("classifier.aspp."):]: v
                          for k, v in state.items()})
    with torch.no_grad():
        got = aspp(torch.from_numpy(x).permute(0, 3, 1, 2))
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want)


def test_global_avg_pool_matches_jax():
    x = _image(5, (2, 7, 9, 5))
    want = np.asarray(jpool.global_avg_pool(jnp.asarray(x)))
    got = pool.global_avg_pool(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    nchw = pool.global_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2),
                                channel_last=False)
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_reference_state_dict_roundtrips_through_jax_converter():
    """A reference-keyed state dict (the port's) -> the JAX package's
    convert_deeplab_checkpoint (read-only) -> deeplab_state_dict_from_jax
    gives back the same tensors, key for key, and the JAX tree has the
    JAX twin's structure and shapes."""
    model = deeplab.init_deeplab_weights(port_twin(),
                                         torch.Generator().manual_seed(0))
    with torch.no_grad():   # non-trivial BN statistics
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    before = model.state_dict()
    variables = convert_deeplab_checkpoint(
        {"model_state": {k: v.numpy() for k, v in before.items()},
         "cur_itrs": 0})
    shapes = jax.eval_shape(jax_twin().init, jax.random.PRNGKey(0),
                            jnp.zeros(INPUT))
    assert (jax.tree_util.tree_map(np.shape, variables)
            == jax.tree_util.tree_map(np.shape, dict(shapes)))
    after = deeplab_state_dict_from_jax(variables)
    assert set(after) == set(before)
    for key in before:
        torch.testing.assert_close(after[key], before[key], rtol=0, atol=0,
                                   check_dtype=False)


def test_v3_head_bridge_gives_the_port_keys():
    """The V3 head (DeepLabHead, one Sequential with ASPP at index 0): the
    bridge maps every JAX variable of a V3 twin onto the port's keys."""
    twin = jax_twin(head=jdeeplab.DeepLabHead,
                    wrapper=jdeeplab.DeepLabV3Plus)
    variables = fill_jax_variables(twin, INPUT, 0)
    model = port_twin(v3plus=False, wrapper=deeplab.DeepLabV3Plus)
    state = deeplab_state_dict_from_jax(variables)
    model.load_state_dict(state)     # strict: every key, every shape
    assert "classifier.classifier.0.convs.4.1.weight" in state


def test_resnet101_fused_route_takes_31_of_33_blocks():
    """deeplabv3plus_embedding_resnet101 at OS16: all but the two strided
    bottlenecks (layer2.0, layer3.0) take the fused route."""
    with torch.device("meta"):
        model = deeplab.deeplabv3plus_embedding_resnet101(fused_blocks=True)
    blocks = {name: m.fused_tile is not None
              for name, m in model.backbone.named_modules()
              if isinstance(m, Bottleneck)}
    assert len(blocks) == 33
    assert [n for n, routed in blocks.items() if not routed] == [
        "layer2.0", "layer3.0"]
    assert model.backbone.layer1[0].conv1.in_channels == 64
    assert model.backbone.layer4[0].conv2.dilation == (1, 1)
    assert model.backbone.layer4[1].conv2.dilation == (2, 2)


def test_jax_pickle_loads_without_jax(tmp_path):
    """The JAX package's DeepLab pickle loads into the port through the
    bridge, and unpickling it names no jax or flax class."""
    variables = twin_variables(2)
    path = str(tmp_path / "best.pkl")
    jax_save_checkpoint(path, variables, {"cur_itrs": 7})
    with open(path, "rb") as f:
        globals_ = {arg for op, arg, _ in pickletools.genops(f)
                    if op.name in ("GLOBAL", "STACK_GLOBAL")
                    or (op.name in ("SHORT_BINUNICODE", "BINUNICODE")
                        and "." in str(arg))}
    assert not any(str(g).startswith(("jax", "flax")) for g in globals_)
    model = port_twin()
    main_deeplab.init_or_load_deeplab(model, path)
    want = deeplab_state_dict_from_jax(variables)
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_reference_pth_loads_natively(tmp_path):
    """A reference ``{"model_state": ...}`` .pth, DataParallel prefixes and
    the embedding's ``centers`` included, loads with load_state_dict."""
    src = deeplab.init_deeplab_weights(port_twin(),
                                       torch.Generator().manual_seed(3))
    state = {"module." + k: v for k, v in src.state_dict().items()}
    state["module.centers"] = 3 * torch.eye(NUM_CLASSES)
    path = str(tmp_path / "best_deeplab.pth")
    torch.save({"model_state": state, "cur_itrs": 10}, path)
    model = main_deeplab.init_or_load_deeplab(port_twin(), path)
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in src.state_dict().items())
    assert set(load_deeplab_state(path)) == set(got)
