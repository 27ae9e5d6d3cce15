"""The rest of the CSAIL model zoo in the port against the JAX package.

Each case builds an encoder + decoder pair twice, as the JAX package's
modules and as the port's, fills the JAX variable tree from a numpy seed
(BN statistics included), carries it into the port through
``train/convert.py state_dict_from_jax`` and runs both forwards in fp32 on
the CPU on the same seeded image, at inference (scores resized to the
image). Encoders are built narrow or shallow where their constructor
allows: ResNet bodies with one block per stage and planes 8..64 (BasicBlock
at output strides 32 and 8, Bottleneck at 32 and 8), ResNeXt's
GroupBottleneck with 4 groups and planes 16..128, HRNetV2 with stages of
(8, 16), (8, 16, 32), (8, 16, 32, 64) channels and one module each
(``test_torch_zoo_hrnet.py``); the MobileNetV2 of ``mobilenetv2dilated``
at its only width (``test_torch_mobilenet.py``). The new decoders run on
the narrow resnet18dilated body (``test_torch_zoo_decoders.py``). The
cases are spread over these files to keep each one's JAX compiles within
a few seconds; this one holds the ResNet and ResNeXt bodies and the
builder's names.

The port's state dict then goes through the JAX package's own reader of
the reference's ``.pth`` files (``convert_csail_encoder``,
``convert_hrnet_encoder``, ``convert_csail_mobilenet_encoder``,
``convert_decoder``) and back through ``state_dict_from_jax`` to the same
keys and values, so a reference checkpoint's keys are the port's. (The
JAX reader puts a C1DeepSup's ``cbr_deepsup`` under the PPM family's
``deepsup/``, where its C1DeepSup does not look; the round trip still
holds, the forward check carries the weights by ``state_dict_from_jax``.)

Tolerance: scores within 1e-4 of their largest magnitude (fp32 convs summed
in another order); the argmax equal on at least 99.9 % of pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.models import decoders as jdec
from open_world_semantic_segmentation_tpu.models.builder import (
    SegmentationModel as JaxSegmentationModel)
from open_world_semantic_segmentation_tpu.models.hrnet import (
    HRNetV2 as JaxHRNetV2)
from open_world_semantic_segmentation_tpu.models.mobilenet import (
    MobileNetV2Dilated as JaxMobileNetV2Dilated)
from open_world_semantic_segmentation_tpu.models.resnet import (
    BasicBlock as JaxBasicBlock, Bottleneck as JaxBottleneck,
    ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.models.resnext import (
    GroupBottleneck as JaxGroupBottleneck)
from open_world_semantic_segmentation_tpu.train import convert as jconvert
from open_world_semantic_segmentation_tpu_torch.models import decoders
from open_world_semantic_segmentation_tpu_torch.models.builder import (
    ModelBuilder, SegmentationModel)
from open_world_semantic_segmentation_tpu_torch.models.hrnet import HRNetV2
from open_world_semantic_segmentation_tpu_torch.models.mobilenet import (
    MobileNetV2Dilated)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.models.resnext import (
    GroupBottleneck)
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    state_dict_from_jax)
from test_torch_model import fill_jax_variables

NUM_CLASS = 13
SIZE = (48, 64)
PLANES = (8, 16, 32, 64)
HRNET = dict(stage_channels=((8, 16), (8, 16, 32), (8, 16, 32, 64)),
             stage_modules=(1, 1, 1))


def _resnet(block, jblock, output_stride, **kw):
    """(JAX, port) shallow ResNet bodies: one block per stage."""
    kw = dict(layers=(1, 1, 1, 1), stem="deep", output_stride=output_stride,
              **kw)
    kw.setdefault("planes", PLANES)
    return (lambda: JaxResNet(block=jblock, **kw),
            lambda: ResNet(block=block, **kw))


ENCODERS = {
    # name -> ((JAX factory, port factory), output width, JAX converter)
    "resnet18": (_resnet(BasicBlock, JaxBasicBlock, 32), 64,
                 jconvert.convert_csail_encoder),
    "resnet18dilated": (_resnet(BasicBlock, JaxBasicBlock, 8), 64,
                        jconvert.convert_csail_encoder),
    "resnet101": (_resnet(Bottleneck, JaxBottleneck, 32), 256,
                  jconvert.convert_csail_encoder),
    "resnet101dilated": (_resnet(Bottleneck, JaxBottleneck, 8), 256,
                         jconvert.convert_csail_encoder),
    "resnext101": (_resnet(GroupBottleneck, JaxGroupBottleneck, 32, groups=4,
                           planes=(16, 32, 64, 128)), 256,
                   jconvert.convert_csail_encoder),
    "hrnetv2": ((lambda: JaxHRNetV2(**HRNET), lambda: HRNetV2(**HRNET)), 120,
                jconvert.convert_hrnet_encoder),
    "mobilenetv2dilated": ((lambda: JaxMobileNetV2Dilated(output_stride=8),
                            lambda: MobileNetV2Dilated(output_stride=8)),
                           320, jconvert.convert_csail_mobilenet_encoder),
}
DECODERS = {
    # name -> (JAX class and keywords, port class and keywords)
    "c1": ((jdec.C1, {}), (decoders.C1, {})),
    "c1_deepsup": ((jdec.C1DeepSup, {}), (decoders.C1DeepSup, {})),
    "ppm": ((jdec.PPM, {}), (decoders.PPM, {})),
    "upernet": ((jdec.UPerNet, {"fpn_dim": 512}),
                (decoders.UPerNet, {"fpn_dim": 512})),
    "upernet_lite": ((jdec.UPerNet, {"fpn_dim": 256}),
                     (decoders.UPerNet, {"fpn_dim": 256})),
}
# the ResNet and ResNeXt bodies, each under the C1 decoder
CASES = [(enc, "c1", False) for enc in ("resnet18", "resnet18dilated",
                                       "resnet101", "resnet101dilated",
                                       "resnext101")]


def case_ids(cases):
    return [f"{e}+{d}" + ("+softmax" if s else "") for e, d, s in cases]


def _pair(encoder, decoder, use_softmax):
    """(JAX model, port model in eval mode) of the pair."""
    (jenc, penc), width, _ = ENCODERS[encoder]
    (jcls, jkw), (pcls, pkw) = DECODERS[decoder]
    if use_softmax:
        jkw = {**jkw, "use_softmax": True}
        pkw = {**pkw, "use_softmax": True}
    jax_model = JaxSegmentationModel(
        encoder=jenc(), decoder=jcls(num_class=NUM_CLASS, fc_dim=width,
                                     **jkw))
    port = SegmentationModel(penc(), pcls(num_class=NUM_CLASS, fc_dim=width,
                                          **pkw)).eval()
    return jax_model, port


def check_zoo_case(encoder, decoder, use_softmax, seed):
    """The pair's port forward against the JAX one (and the round trip of
    its state dict through the JAX package's .pth reader)."""
    jax_model, port = _pair(encoder, decoder, use_softmax)
    variables = fill_jax_variables(jax_model, (1, *SIZE, 3), seed)
    enc, dec = state_dict_from_jax(variables)
    port.encoder.load_state_dict(enc)
    port.decoder.load_state_dict(dec)

    x = np.random.default_rng(100 + seed).standard_normal(
        (1, *SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_model.apply, static_argnames="seg_size")(
        variables, jnp.asarray(x), seg_size=SIZE)["scores"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), seg_size=SIZE)["scores"].numpy()
    assert got.shape == want.shape == (1, *SIZE, NUM_CLASS)
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999
    if use_softmax:
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)

    # the port's keys through the JAX package's .pth reader and back
    convert_encoder = ENCODERS[encoder][2]
    for part, convert, state in (
            ("encoder", convert_encoder, port.encoder.state_dict()),
            ("decoder", jconvert.convert_decoder,
             port.decoder.state_dict())):
        flax = convert({k: v.numpy() for k, v in state.items()})
        other = {"encoder": {}, "decoder": {}}
        back = state_dict_from_jax({
            "params": {**other, part: flax["params"]},
            "batch_stats": {**other, part: flax["batch_stats"]}})
        back = back[0] if part == "encoder" else back[1]
        want_keys = {k for k in state if not k.endswith("num_batches_tracked")}
        assert {k for k in back
                if not k.endswith("num_batches_tracked")} == want_keys, part
        for key in want_keys:
            np.testing.assert_array_equal(back[key].numpy(),
                                          state[key].numpy(), err_msg=key)
    return port


@pytest.mark.parametrize("encoder,decoder,use_softmax", CASES,
                         ids=case_ids(CASES))
def test_zoo_matches_jax(encoder, decoder, use_softmax):
    check_zoo_case(encoder, decoder, use_softmax,
                   CASES.index((encoder, decoder, use_softmax)))


@pytest.mark.parametrize("arch", sorted(ModelBuilder.ENCODER_FC_DIM))
def test_model_builder_builds_every_encoder(arch):
    """Each name of the JAX ModelBuilder: its body, output stride and
    output width; ``fused_blocks`` only where Bottlenecks take it."""
    with torch.device("meta"):          # shapes only: no initialisation
        enc = ModelBuilder.build_encoder(arch)
    enc = enc.to_empty(device="cpu").eval()
    with torch.no_grad():
        outs = enc(torch.zeros(1, 3, 32, 32))
    stride = {"hrnetv2": 4}.get(arch, 8 if "dilated" in arch else 32)
    assert outs[-1].shape == (1, ModelBuilder.ENCODER_FC_DIM[arch],
                              32 // stride, 32 // stride)
    if arch in ModelBuilder.FUSED_ENCODERS:
        with torch.device("meta"):
            fused = ModelBuilder.build_encoder(arch, fused_blocks=True)
        routed = [m for m in fused.modules()
                  if getattr(m, "fused_tile", None) is not None]
        n_blocks = sum(type(m) is Bottleneck for m in fused.modules())
        # every stride-1 Bottleneck: all but the strided first blocks
        strided = {"resnet50": 3, "resnet101": 3, "resnet50dilated": 1,
                   "resnet101dilated": 1, "hrnetv2": 0}[arch]
        assert len(routed) == n_blocks - strided
    else:
        with pytest.raises(ValueError, match="fused_blocks"):
            ModelBuilder.build_encoder(arch, fused_blocks=True)
