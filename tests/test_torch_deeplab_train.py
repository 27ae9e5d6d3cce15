"""DeepLab training of the port against the JAX package's, on the CPU.

- ``ops/dilated.py dilated_conv3x3_shift`` against the JAX function at
  rates 6, 12 and 18 (fp32, within 1e-5 of the largest magnitude), its
  gradient against the port's native conv (float64, 1e-10 relative), and
  the ASPP's routing (``dilated_impl``);
- each train transform against the JAX one (``random.seed(s)`` there,
  ``random.Random(s)`` here): images and labels equal;
- ``deeplab_cross_entropy`` (with and without the metric terms),
  ``focal_loss`` and ``distillation_loss`` in float64, within 1e-10;
- one ``DeepLabTrainStep`` of the narrow DeepLab twin of
  ``tests/test_torch_deeplab.py`` (7x7 stem, layers (1, 1, 2, 1), planes
  8..64, OS16, 16 classes) against the JAX ``make_deeplab_train_step``, in
  float64 on both sides (JAX under ``jax.enable_x64`` with its float64
  dataflows: ``OWSS_ASPP_PROJECT=concat`` and ``OWSS_DILATED_IMPL=native``,
  since its per-branch projection and its shift form accumulate in
  float32; all compute the same function), dropout held out: the loss, the
  updated parameters and the BN statistics within 1e-8 (relative, and of
  the tensor's largest magnitude);
- the DeepLab checkpoints (save, resume) and ``cli.main_deeplab.main`` on
  the CPU with the twin swapped in for the factory (``monkeypatch``).
"""

import contextlib
import functools
import os
import random
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from open_world_semantic_segmentation_tpu.cli import (
    main_deeplab as jax_main_deeplab)
from open_world_semantic_segmentation_tpu.data import (
    transforms as jax_transforms)
from open_world_semantic_segmentation_tpu.models import deeplab as jdeeplab
from open_world_semantic_segmentation_tpu.models.layers import (
    BNConfig as JaxBNConfig)
from open_world_semantic_segmentation_tpu.models.resnet import (
    Bottleneck as JaxBottleneck, ResNet as JaxResNet)
from open_world_semantic_segmentation_tpu.ops import dilated as jdilated
from open_world_semantic_segmentation_tpu.train import (
    losses as jax_losses, optim as jax_optim)
from open_world_semantic_segmentation_tpu.train.state import (
    TrainState, make_deeplab_train_step)
from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data import transforms
from open_world_semantic_segmentation_tpu_torch.models import deeplab
from open_world_semantic_segmentation_tpu_torch.models.layers import (
    BNConfig, ShiftDilatedConv2d)
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    Bottleneck, ResNet)
from open_world_semantic_segmentation_tpu_torch.ops.dilated import (
    dilated_conv3x3_shift)
from open_world_semantic_segmentation_tpu_torch.train import checkpoint
from open_world_semantic_segmentation_tpu_torch.train import losses
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    deeplab_state_dict_from_jax)
from open_world_semantic_segmentation_tpu_torch.train.optim import (
    backbone_classifier_optimizer, poly_schedule)
from open_world_semantic_segmentation_tpu_torch.train.state import (
    DeepLabTrainStep)
from test_torch_deeplab import NUM_CLASSES, RATES, TWIN
from test_torch_model import fill_jax_variables, jax_variable_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_synthetic_data import make_cityscapes  # noqa: E402

LR, MAX_ITERS, WD = 0.05, 10, 1e-4
BATCH = (2, 32, 64)        # images of the float64 step: batch, h, w


# -- the twins ---------------------------------------------------------------
def jax_backbone(train=False, dtype=jnp.float32):
    return JaxResNet(block=JaxBottleneck, name="backbone", train=train,
                     dtype=dtype, bn=JaxBNConfig(momentum=0.01), **TWIN)


def jax_embedding_twin(num_classes=NUM_CLASSES, train=False,
                       dtype=jnp.float32):
    return jdeeplab.DeepLabV3PlusEmbedding(
        backbone=jax_backbone(train, dtype),
        head=jdeeplab.DeepLabHeadV3Plus(num_classes, RATES, train=train,
                                        dtype=dtype, name="head"))


def port_backbone(fused_blocks=False):
    return ResNet(block=Bottleneck, fused_blocks=fused_blocks,
                  bn=BNConfig(momentum=0.01), **TWIN)


def port_embedding_twin(num_classes=NUM_CLASSES, output_stride=16, *,
                        fused_blocks=False, dilated_impl="shift"):
    """The twin with a factory's signature (``MODEL_MAP``)."""
    return deeplab.DeepLabV3PlusEmbedding(
        port_backbone(fused_blocks),
        deeplab.DeepLabHeadV3Plus(256, 32, num_classes, RATES,
                                  dilated_impl=dilated_impl))


def no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: ``nn.Dropout`` as the identity."""
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


@contextlib.contextmanager
def jax_float64():
    """x64 on, the JAX package's float64 dataflows, dropout held out."""
    saved = {k: os.environ.get(k)
             for k in ("OWSS_ASPP_PROJECT", "OWSS_DILATED_IMPL")}
    os.environ.update(OWSS_ASPP_PROJECT="concat", OWSS_DILATED_IMPL="native")
    try:
        with jax.enable_x64(True), fnn.intercept_methods(no_dropout):
            yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def to_float64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def train_mode_without_dropout(model, dtype=torch.float64):
    model = model.train().to(dtype)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    return model


def seg_batch(seed, num_classes=NUM_CLASSES, shape=BATCH):
    """A seeded image batch (NHWC float64) and labels with 255 pixels."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape + (3,))
    label = rng.integers(0, num_classes, shape).astype(np.int32)
    label[rng.random(shape) < 0.2] = 255
    return img, label


def assert_state_close(got, want, tol=1e-8):
    """Every tensor of ``want`` within ``tol`` relative and ``tol`` of its
    largest magnitude."""
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        w = w.double().numpy()
        np.testing.assert_allclose(got[key].double().numpy(), w, rtol=tol,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=key)


# -- ops/dilated.py ----------------------------------------------------------
@pytest.mark.parametrize("rate", [6, 12, 18])
def test_dilated_shift_matches_jax_and_native_gradient(rate):
    rng = np.random.default_rng(rate)
    x = rng.standard_normal((2, 40, 44, 6)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 6, 5)) / 8).astype(np.float32)
    want = np.asarray(jdilated.dilated_conv3x3_shift(
        jnp.asarray(x), jnp.asarray(kernel), (rate, rate)))
    weight = torch.from_numpy(kernel).permute(3, 2, 0, 1)       # OIHW
    got = dilated_conv3x3_shift(torch.from_numpy(x).permute(0, 3, 1, 2),
                                weight, rate).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))

    x64 = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    w64 = weight.double().requires_grad_()
    grads = []
    for fn in (lambda: dilated_conv3x3_shift(x64, w64, rate),
               lambda: F.conv2d(x64, w64, padding=rate, dilation=rate)):
        out = fn()
        grads.append(torch.autograd.grad((out * out.detach()).sum(),
                                         [x64, w64]))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-10 * float(w.abs().max()))


def test_aspp_routes_dilated_convs():
    """Rates of 6 and more take the shift form by default, the native conv
    with ``dilated_impl="native"``; the state dict and the output are the
    same either way."""
    models = {impl: deeplab.ASPP(24, RATES, dilated_impl=impl).double()
              .eval() for impl in ("shift", "native")}
    routed = [type(models["shift"].convs[i][0]) for i in range(4)]
    assert routed == [torch.nn.Conv2d] + [ShiftDilatedConv2d] * 3
    assert not any(isinstance(m, ShiftDilatedConv2d)
                   for m in models["native"].modules())
    state = models["shift"].state_dict()
    models["native"].load_state_dict(state)
    assert "convs.1.0.weight" in state
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 24, 13, 21)))
    with torch.no_grad():
        a, b = (models[k](x) for k in ("shift", "native"))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="dilated_impl"):
        deeplab.ASPP(24, RATES, dilated_impl="xla")


# -- data/transforms.py ------------------------------------------------------
def _pair(seed, size=(53, 37)):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, size[::-1] + (3,),
                                       dtype=np.uint8), "RGB")
    lbl = Image.fromarray(rng.integers(0, 34, size[::-1], dtype=np.uint8),
                          "L")
    return img, lbl


TRANSFORMS = {
    "hflip": lambda m: m.ExtRandomHorizontalFlip(),
    "vflip": lambda m: m.ExtRandomVerticalFlip(),
    "center_crop": lambda m: m.ExtCenterCrop(20),
    "random_scale": lambda m: m.ExtRandomScale((0.5, 2.0)),
    "scale": lambda m: m.ExtScale(0.7),
    "resize_short": lambda m: m.ExtResize(24),
    "resize_hw": lambda m: m.ExtResize((20, 30)),
    "random_crop": lambda m: m.ExtRandomCrop(25),
    "random_crop_padding": lambda m: m.ExtRandomCrop(20, padding=3),
    "random_crop_pad_if_needed": lambda m: m.ExtRandomCrop(
        60, pad_if_needed=True),
    "color_jitter": lambda m: m.ExtColorJitter(0.5, 0.5, 0.5),
    "cityscapes_train": lambda m: (jax_main_deeplab if m is jax_transforms
                                   else main_deeplab).get_transforms(24)[0],
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_train_transform_matches_jax(name):
    for seed in range(4):
        img, lbl = _pair(seed)
        random.seed(seed)
        want = TRANSFORMS[name](jax_transforms)(img, lbl)
        got = TRANSFORMS[name](transforms)(img, lbl, random.Random(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if name not in ("center_crop", "scale", "resize_short", "resize_hw"):
        with pytest.raises(ValueError, match="random.Random"):
            TRANSFORMS[name](transforms)(img, lbl)


# -- train/losses.py ---------------------------------------------------------
def _logits(seed, k=NUM_CLASSES, shape=(2, 9, 11)):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape + (k,)) * 3
    labels = rng.integers(0, k, shape).astype(np.int32)
    labels[rng.random(shape) < 0.2] = 255
    return logits, labels


LOSS_CASES = {
    "ce": lambda m, lg, lb, f1, f2: m.deeplab_cross_entropy(lg, lb),
    "ce_metric_terms": lambda m, lg, lb, f1, f2: m.deeplab_cross_entropy(
        lg, lb, f2, alpha=0.3, beta=0.2, gamma=0.5, use_metric_terms=True),
    "focal": lambda m, lg, lb, f1, f2: m.focal_loss(lg, lb),
    "focal_gamma2_sum": lambda m, lg, lb, f1, f2: m.focal_loss(
        lg, lb, alpha=0.5, gamma=2.0, size_average=False),
    "distillation": lambda m, lg, lb, f1, f2: m.distillation_loss(
        lg, lb, f1, f2),
    "distillation_feature": lambda m, lg, lb, f1, f2: m.distillation_loss(
        lg, lb, f1, f2, use_distillation_term=True, dis_weight=0.3),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_deeplab_losses_match_jax_float64(case):
    logits, labels = _logits(5)
    labels[0, :3] = 16                     # novel pixels for distillation
    rng = np.random.default_rng(6)
    f1 = rng.standard_normal(labels.shape + (NUM_CLASSES - 1,))
    f2 = rng.standard_normal(labels.shape + (NUM_CLASSES,))
    with jax.enable_x64(True):
        want = float(LOSS_CASES[case](jax_losses, *(
            jnp.asarray(a) for a in (logits, labels, f1, f2))))
    got = LOSS_CASES[case](losses, *(
        torch.from_numpy(a) for a in (logits, labels, f1, f2)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-10, atol=1e-12)


# -- train/state.py DeepLabTrainStep ------------------------------------------
@functools.lru_cache(maxsize=None)
def twin_shapes(num_classes=NUM_CLASSES):
    """The twin's variable shapes, traced once per process."""
    return jax_variable_shapes(jax_embedding_twin(num_classes),
                               (1,) + BATCH[1:] + (3,))


def twin_variables(seed=0, num_classes=NUM_CLASSES):
    return fill_jax_variables(None, None, seed,
                              shapes=twin_shapes(num_classes))


@pytest.fixture(scope="module")
def jax_deeplab_step64():
    variables = twin_variables()
    img, label = seg_batch(1)
    with jax_float64():
        model = jax_embedding_twin(train=True, dtype=jnp.float64)
        v64 = to_float64(variables)
        tx = jax_optim.backbone_classifier_optimizer(
            v64["params"], lr=jax_optim.poly_schedule(LR, MAX_ITERS),
            momentum=0.9, weight_decay=WD)
        state = TrainState.create(params=v64["params"],
                                  batch_stats=v64["batch_stats"], tx=tx)
        step = make_deeplab_train_step(model, guard=True)
        state, metrics = step(state, {"image": jnp.asarray(img),
                                      "label": jnp.asarray(label)})
        return dict(variables=variables, img=img, label=label,
                    loss=float(metrics["loss"]), acc=float(metrics["acc"]),
                    skipped=bool(metrics["skipped"]),
                    state=deeplab_state_dict_from_jax(as_numpy(
                        {"params": state.params,
                         "batch_stats": state.batch_stats})))


def test_deeplab_train_step_matches_jax_float64(jax_deeplab_step64):
    ref = jax_deeplab_step64
    model = port_embedding_twin()
    model.load_state_dict(deeplab_state_dict_from_jax(ref["variables"]))
    model = train_mode_without_dropout(model)
    opt = backbone_classifier_optimizer(
        model, lr=poly_schedule(LR, MAX_ITERS), momentum=0.9,
        weight_decay=WD)
    step = DeepLabTrainStep(model, opt, guard=True, dtype=torch.float64)
    metrics = step({"image": torch.from_numpy(ref["img"]),
                    "label": torch.from_numpy(ref["label"])})
    assert not ref["skipped"] and not bool(metrics["skipped"])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=1e-8)
    np.testing.assert_allclose(float(metrics["acc"]), ref["acc"], rtol=1e-8)
    assert_state_close(model.state_dict(), ref["state"])


# -- checkpoints and the CLI ---------------------------------------------------
@pytest.fixture(scope="module")
def cs_tree(tmp_path_factory):
    return make_cityscapes(str(tmp_path_factory.mktemp("cs")),
                           splits=("train", "val"), n=2, h=48, w=96)


def _cfg(tree, out, *opts):
    return load_config("configs/cityscapes_embedding.yaml", [
        "DATASET.root_dataset", tree, "DEEPLAB.crop_size", "40",
        "DEEPLAB.batch_size", "2", "DEEPLAB.total_itrs", "4",
        "DEEPLAB.val_interval", "2", "DIR", str(out), *opts])


def test_main_deeplab_trains_saves_and_resumes(cs_tree, tmp_path,
                                               monkeypatch):
    """``cli.main_deeplab.main`` on the CPU in fp32 with the twin: two
    steps write ``latest.pth`` and ``best.pth`` (the reference's dict);
    with DEEPLAB.continue_training the next run resumes at step 2 with the
    saved model and momentum, and stops at total_itrs."""
    monkeypatch.setitem(main_deeplab.MODEL_MAP,
                        "deeplabv3plus_embedding_resnet101",
                        port_embedding_twin)
    cfg = _cfg(cs_tree, tmp_path)
    first = main_deeplab.main(cfg, torch.float32, max_steps=2, device="cpu",
                              log_every=1)
    assert first["steps"] == 2 and first["skipped"] == 0
    assert len(first["validations"]) == 1
    assert all(np.isfinite(e["loss"]) for e in first["log"])
    latest = torch.load(tmp_path / "latest.pth")
    assert latest["cur_itrs"] == 2
    assert (tmp_path / "best.pth").exists() == (first["best_score"] > 0)

    model = port_embedding_twin().train()
    opt = backbone_classifier_optimizer(model, lr=poly_schedule(0.1, 4))
    cur, best = checkpoint.load_deeplab_checkpoint(
        str(tmp_path / "latest.pth"), model, opt)
    assert (cur, best) == (2, latest["best_score"])
    for key, value in model.state_dict().items():
        assert torch.equal(value, latest["model_state"][key]), key
    assert any(float(opt.state[p]["momentum_buffer"].abs().max()) > 0
               for p in model.parameters())
    assert all(callable(g["schedule"]) for g in opt.param_groups)

    cfg.DEEPLAB.continue_training = True
    second = main_deeplab.main(cfg, torch.float32, device="cpu",
                               log_every=1)
    assert second["cur_itrs"] == 4 and second["steps"] == 2
    assert [e["step"] for e in second["log"]] == [3, 4]


def test_cityscapes_train_samples_are_seeded(cs_tree):
    """A train sample's crop, jitter and flip follow (seed, epoch, index):
    the same twice, another in the next epoch."""
    cfg = _cfg(cs_tree, "unused")
    ds = main_deeplab.get_train_dataset(
        cfg, main_deeplab.get_transforms(40)[0])
    a, b = ds[1][0], ds[1][0]
    np.testing.assert_array_equal(a, b)
    ds.set_epoch(1)
    assert not np.array_equal(ds[1][0], a)
