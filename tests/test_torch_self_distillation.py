"""The incremental few-shot training of the port (FT / PLM self-distillation,
teacher-student distillation) against the JAX package's, on the CPU.

- ``pseudo_label`` and ``merge_head_predictions``: exactly equal;
- the multi-head weight bridge (``deeplab_state_dict_from_jax`` of the
  two-head model): the port's two-head twin against the JAX twin in fp32,
  within 1e-4 of the largest magnitude, the argmax equal;
- the partial load: a fresh ``classifier_1`` and a 17-class student
  classifier keep their init, everything else is loaded;
- one self-distillation step (the JAX ``make_self_distillation_step``) and
  one distillation step (the first step of the JAX
  ``cli.main_distillation.main``, its loss read through a debug callback)
  on the narrow twin of ``tests/test_torch_deeplab_train.py``, in float64
  on both sides with dropout held out: the loss, the updated parameters
  and the BN state within 1e-8; the frozen parameters and the kept BN
  statistics bit-identical;
- the CLIs on the CPU (``cli.self_distillation`` train and eval,
  ``cli.main_distillation``) with the twins swapped in by ``monkeypatch``.

The JAX package's Cityscapes split list lacks ``test_car_5_shot``, so its
distillation CLI runs here with FEWSHOT.shots 2 (the ``train`` split).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_world_semantic_segmentation_tpu.cli import (
    main_deeplab as jax_main_deeplab,
    main_distillation as jax_main_distillation,
    self_distillation as jax_self_distillation)
from open_world_semantic_segmentation_tpu.core.config import (
    load_config as jax_load_config)
from open_world_semantic_segmentation_tpu.fewshot import (
    self_distillation as jsd)
from open_world_semantic_segmentation_tpu.models import deeplab as jdeeplab
from open_world_semantic_segmentation_tpu.train import optim as jax_optim
from open_world_semantic_segmentation_tpu.train.convert import (
    convert_deeplab_checkpoint)
from open_world_semantic_segmentation_tpu.train.state import TrainState
from open_world_semantic_segmentation_tpu_torch.cli import (
    main_deeplab, main_distillation, self_distillation)
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data.cityscapes import (
    Cityscapes)
from open_world_semantic_segmentation_tpu_torch.data.loader import (
    batch_iterator)
from open_world_semantic_segmentation_tpu_torch.fewshot import (
    self_distillation as sd)
from open_world_semantic_segmentation_tpu_torch.fewshot.prototypes import (
    npm_label_remap)
from open_world_semantic_segmentation_tpu_torch.models import deeplab
from open_world_semantic_segmentation_tpu_torch.train.checkpoint import (
    load_partial, save_model_checkpoint)
from open_world_semantic_segmentation_tpu_torch.train.convert import (
    deeplab_state_dict_from_jax)
from open_world_semantic_segmentation_tpu_torch.train.optim import (
    backbone_classifier_optimizer, poly_schedule)
from test_torch_deeplab import NUM_CLASSES, RATES
from test_torch_deeplab_train import (
    BATCH, LR, MAX_ITERS, WD, as_numpy, assert_state_close, jax_backbone,
    jax_embedding_twin, jax_float64, port_backbone, port_embedding_twin,
    seg_batch, to_float64, train_mode_without_dropout, twin_variables)
from test_torch_model import fill_jax_variables, jax_variable_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_synthetic_data import make_cityscapes  # noqa: E402

HEADS = ("classifier", "classifier_1")


def jax_sd_twin(train=False, dtype=jnp.float32):
    return jdeeplab.DeepLabV3PlusSelfDistillation(
        backbone=jax_backbone(train, dtype), base_classes=NUM_CLASSES,
        cls_novel=1, aspp_dilate=RATES, train=train, dtype=dtype)


def port_sd_twin(num_classes=NUM_CLASSES, output_stride=16, *,
                 fused_blocks=False, dilated_impl="shift", cls_novel=1):
    """The two-head twin with the factory's signature."""
    return deeplab.DeepLabV3PlusSelfDistillation(
        port_backbone(fused_blocks), num_classes, cls_novel, RATES,
        in_channels=256, low_level_channels=32, dilated_impl=dilated_impl)


@functools.lru_cache(maxsize=None)
def sd_shapes():
    """The two-head twin's variable shapes, traced once per process."""
    return jax_variable_shapes(jax_sd_twin(), (1,) + BATCH[1:] + (3,))


def sd_variables(seed=0):
    return fill_jax_variables(None, None, seed, shapes=sd_shapes())


def _head_logits(seed, ks=(16, 17, 18), shape=(2, 7, 9)):
    rng = np.random.default_rng(seed)
    logits = [rng.standard_normal(shape + (k,)) for k in ks]
    for i, lg in enumerate(logits[1:]):
        lg[..., 16 + i] += 1.5 * (rng.random(shape) < 0.3)   # novel wins
    labels = rng.integers(0, 16, shape).astype(np.int32)
    labels[rng.random(shape) < 0.25] = 255
    return logits, labels


# -- fewshot/self_distillation.py ----------------------------------------------
@pytest.mark.parametrize("novel_cls", [1, 2])
@pytest.mark.parametrize("zero_to_novel", [True, False])
def test_pseudo_label_matches_jax(novel_cls, zero_to_novel):
    logits, labels = _head_logits(novel_cls)
    logits = logits[:novel_cls + 1]
    want = np.asarray(jsd.pseudo_label(
        labels, [jnp.asarray(x) for x in logits], novel_cls=novel_cls,
        support_zero_to_novel=zero_to_novel))
    got = sd.pseudo_label(torch.from_numpy(labels),
                          [torch.from_numpy(x) for x in logits],
                          novel_cls=novel_cls,
                          support_zero_to_novel=zero_to_novel)
    np.testing.assert_array_equal(got.numpy(), want)
    if zero_to_novel:
        assert (want == 15 + novel_cls).any()


@pytest.mark.parametrize("variant", ["plm_all", "plm_latest"])
@pytest.mark.parametrize("novel_cls", [1, 2])
def test_merge_head_predictions_matches_jax(variant, novel_cls):
    logits, _ = _head_logits(10 + novel_cls)
    logits = logits[:novel_cls + 1]
    want = np.asarray(jsd.merge_head_predictions(
        [jnp.asarray(x) for x in logits], variant=variant))
    got = sd.merge_head_predictions([torch.from_numpy(x) for x in logits],
                                    variant=variant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 16).any()
    with pytest.raises(ValueError, match="variant"):
        sd.merge_head_predictions(logits, variant="npm")


def test_eval_remap_is_npm():
    labels = torch.arange(0, 256, dtype=torch.int64)
    assert torch.equal(sd.self_distillation_eval_remap(labels),
                       npm_label_remap(labels))
    np.testing.assert_array_equal(
        sd.self_distillation_eval_remap(labels).numpy(),
        np.asarray(jsd.self_distillation_eval_remap(jnp.asarray(
            labels.numpy()))))


# -- the bridge and the partial load ---------------------------------------------
def test_two_head_bridge_matches_jax():
    variables = sd_variables(3)
    x = np.random.default_rng(4).standard_normal(
        (1,) + BATCH[1:] + (3,)).astype(np.float32)
    want = jax.jit(jax_sd_twin().apply)(variables, jnp.asarray(x))
    state = deeplab_state_dict_from_jax(variables)
    model = port_sd_twin().eval()
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 2
        for g, w in zip(g_list, w_list):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy().argmax(-1),
                                      np.asarray(w).argmax(-1))
    # and back through the JAX package's converter
    back = convert_deeplab_checkpoint(
        {k: v for k, v in state.items()
         if not k.endswith("num_batches_tracked")}, head_names=HEADS)
    for coll in ("params", "batch_stats"):
        flat_w = jax.tree_util.tree_leaves_with_path(variables[coll])
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_partial_load_keeps_new_heads():
    base = port_embedding_twin()
    deeplab.init_deeplab_weights(base, torch.Generator().manual_seed(0))
    state = base.state_dict()
    model = port_sd_twin()
    deeplab.init_deeplab_weights(model, torch.Generator().manual_seed(1))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    kept = load_partial(model, state)
    assert kept and all(k.startswith("classifier_1.") for k in kept)
    assert len(kept) == len([k for k in fresh
                             if k.startswith("classifier_1.")])
    for key, value in model.state_dict().items():
        want = fresh[key] if key in kept else state[key]
        assert torch.equal(value, want), key

    student = port_embedding_twin(NUM_CLASSES + 1)
    kept = load_partial(student, state)
    assert sorted(kept) == ["classifier.classifier.3.bias",
                            "classifier.classifier.3.weight"]


# -- the steps ------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_sd_step64():
    variables = sd_variables()
    img, label = seg_batch(2)
    label[:, :4] = 0                                # support pixels
    with jax_float64():
        model = jax_sd_twin(train=True, dtype=jnp.float64)
        v64 = to_float64(variables)
        tx = jax_optim.backbone_classifier_optimizer(
            v64["params"], lr=jax_optim.poly_schedule(LR, MAX_ITERS),
            momentum=0.9, weight_decay=WD,
            frozen_keys=("backbone", "classifier"))
        state = TrainState.create(params=v64["params"],
                                  batch_stats=v64["batch_stats"], tx=tx)
        step = jax_self_distillation.make_self_distillation_step(
            model, novel_cls=1, base_classes=NUM_CLASSES,
            rng=jax.random.PRNGKey(0))
        state, loss = step(state, {"image": jnp.asarray(img),
                                   "label": jnp.asarray(label)})
        return dict(variables=variables, img=img, label=label,
                    loss=float(loss),
                    state=deeplab_state_dict_from_jax(as_numpy(
                        {"params": state.params,
                         "batch_stats": state.batch_stats})))


def test_self_distillation_step_matches_jax_float64(jax_sd_step64):
    ref = jax_sd_step64
    model = port_sd_twin()
    model.load_state_dict(deeplab_state_dict_from_jax(ref["variables"]))
    model = train_mode_without_dropout(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = backbone_classifier_optimizer(
        model, lr=poly_schedule(LR, MAX_ITERS), momentum=0.9,
        weight_decay=WD, frozen_keys=("backbone", "classifier"))
    step = self_distillation.SelfDistillationStep(
        model, opt, novel_cls=1, base_classes=NUM_CLASSES,
        dtype=torch.float64)
    metrics = step({"image": torch.from_numpy(ref["img"]),
                    "label": torch.from_numpy(ref["label"])})
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=1e-8)
    after = model.state_dict()
    assert_state_close(after, ref["state"])
    params = dict(model.named_parameters())
    for key, value in after.items():
        frozen = not key.startswith("classifier_1.") or key not in params
        if frozen:      # frozen parameters and every BN statistic
            assert torch.equal(value, before[key]), key
    assert not torch.equal(after["classifier_1.classifier.3.weight"],
                           before["classifier_1.classifier.3.weight"])


@pytest.fixture(scope="module")
def distillation_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill")
    tree = make_cityscapes(str(root / "cs"), splits=("train", "val"), n=4,
                           h=32, w=64, seed=3)
    teacher_vars = twin_variables(5)
    student = port_embedding_twin(NUM_CLASSES + 1)
    deeplab.init_deeplab_weights(student, torch.Generator().manual_seed(1))
    load_partial(student, deeplab_state_dict_from_jax(teacher_vars))
    return dict(root=root, tree=tree, teacher_vars=teacher_vars,
                student_state=student.state_dict())


def _val_transform_for_training(crop_size, dataset="cityscapes"):
    """Both packages' val transform in the train slot: a deterministic
    batch for the step parity (the random transforms are held against
    each other in ``tests/test_torch_deeplab_train.py``)."""
    _, val_tf = jax_main_deeplab.get_transforms(crop_size)
    return val_tf, val_tf


def test_distillation_step_matches_jax_float64(distillation_setup,
                                                monkeypatch):
    s = distillation_setup
    opts = ["DATASET.root_dataset", s["tree"], "DEEPLAB.batch_size", "2",
            "DEEPLAB.lr", str(LR), "DEEPLAB.total_itrs", str(MAX_ITERS),
            "DEEPLAB.weight_decay", str(WD), "FEWSHOT.shots", "2",
            "DIR", str(s["root"] / "jax_out")]
    jcfg = jax_load_config("configs/cityscapes_embedding.yaml", opts)

    def jax_factory(num_classes, output_stride, train, dtype):
        return jax_embedding_twin(num_classes, train, dtype)

    seen = []
    loss_fn = jax_main_distillation.distillation_loss

    def recording_loss(*args, **kwargs):
        loss = loss_fn(*args, **kwargs)
        jax.debug.callback(lambda v: seen.append(float(v)), loss)
        return loss

    monkeypatch.setitem(jax_main_deeplab.MODEL_MAP,
                        "deeplabv3plus_embedding_resnet101", jax_factory)
    monkeypatch.setattr(jax_main_distillation, "get_transforms",
                        _val_transform_for_training)
    monkeypatch.setattr(jax_main_distillation, "distillation_loss",
                        recording_loss)
    student0 = convert_deeplab_checkpoint(
        {k: v.numpy() for k, v in s["student_state"].items()
         if not k.endswith("num_batches_tracked")})
    with jax_float64():
        state = jax_main_distillation.main(
            jcfg, jnp.float64, max_steps=1,
            teacher_variables=to_float64(s["teacher_vars"]),
            student_variables=to_float64(student0))
        want = deeplab_state_dict_from_jax(as_numpy(
            {"params": state.params, "batch_stats": state.batch_stats}))
    assert len(seen) == 1

    # the port's step on the same first batch
    cfg = load_config("configs/cityscapes_embedding.yaml", opts)
    ds = Cityscapes(s["tree"], split="train",
                    transform=main_deeplab.get_transforms(768)[1],
                    unknown_target=tuple(cfg.DEEPLAB.unknown_target))
    image, target, _ = next(batch_iterator(ds, 2, seed=1, num_workers=0))
    teacher = port_embedding_twin().eval().double()
    teacher.load_state_dict(deeplab_state_dict_from_jax(s["teacher_vars"]))
    teacher.requires_grad_(False)
    student = port_embedding_twin(NUM_CLASSES + 1)
    student.load_state_dict(s["student_state"])
    student = train_mode_without_dropout(student)
    opt = backbone_classifier_optimizer(
        student, lr=poly_schedule(LR, MAX_ITERS), momentum=0.9,
        weight_decay=WD)
    step = main_distillation.DistillationStep(
        student, teacher, opt, novel_id=NUM_CLASSES, dtype=torch.float64)
    metrics = step({"image": torch.from_numpy(image).double(),
                    "label": torch.from_numpy(target.astype(np.int32))})
    np.testing.assert_allclose(float(metrics["loss"]), seen[0], rtol=1e-8)
    assert_state_close(student.state_dict(), want)


# -- the CLIs on the CPU -----------------------------------------------------------
@pytest.fixture(scope="module")
def fewshot_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    tree = make_cityscapes(str(root / "cs"),
                           splits=("train", "val", "test_car_5_shot"), n=2,
                           h=48, w=96, seed=4)
    base = port_embedding_twin()
    deeplab.init_deeplab_weights(base, torch.Generator().manual_seed(7))
    path = str(root / "base.pth")
    save_model_checkpoint(path, base)
    return root, tree, path


def _cli_cfg(tree, out, weights, *opts):
    return load_config("configs/self_distillation.yaml", [
        "DATASET.root_dataset", tree, "DEEPLAB.crop_size", "40",
        "DEEPLAB.batch_size", "2", "MODEL.weights_encoder", weights,
        "DIR", str(out), *opts])


def test_self_distillation_cli_trains_and_evaluates(fewshot_tree, tmp_path,
                                                    monkeypatch):
    """Two fp32 train steps from the base checkpoint (partial load): the
    backbone, the base head and every BN statistic stay bit-identical to
    the checkpoint, ``classifier_1`` moves; then the eval of the written
    checkpoint, unfused and fused (the plain version on the CPU), gives
    finite metrics."""
    root, tree, weights = fewshot_tree
    monkeypatch.setitem(main_deeplab.MODEL_MAP, self_distillation.MODEL,
                        port_sd_twin)
    cfg = _cli_cfg(tree, tmp_path, weights)
    out = self_distillation.main(cfg, torch.float32, mode="train",
                                 max_steps=2, device="cpu", log_every=1)
    assert out["steps"] == 2 and len(out["log"]) == 2
    assert all(np.isfinite(e["loss"]) for e in out["log"])
    trained = torch.load(out["path"])["model_state"]
    base = torch.load(weights)["model_state"]
    fresh = port_sd_twin()
    deeplab.init_deeplab_weights(fresh, torch.Generator().manual_seed(
        cfg.DEEPLAB.random_seed))
    for key, value in trained.items():
        if key.startswith("classifier_1."):
            continue
        assert torch.equal(value, base[key]), key
    assert not torch.equal(trained["classifier_1.classifier.3.weight"],
                           fresh.state_dict()["classifier_1.classifier.3."
                                              "weight"])
    for fused in (False, True):
        ecfg = _cli_cfg(tree, tmp_path, out["path"])
        score = self_distillation.main(ecfg, torch.float32, mode="eval",
                                       device="cpu", fused_blocks=fused)
        assert score["images"] == 2
        assert np.isfinite(score["Overall Acc"])
        assert np.isfinite(score["Mean IoU"])


def test_main_distillation_cli_trains(fewshot_tree, tmp_path, monkeypatch):
    """The student starts as the teacher (backbone and head but its
    17-class classifier) and trains two fp32 steps with finite losses."""
    root, tree, weights = fewshot_tree
    monkeypatch.setitem(main_deeplab.MODEL_MAP,
                        "deeplabv3plus_embedding_resnet101",
                        port_embedding_twin)
    cfg = _cli_cfg(tree, tmp_path, weights,
                   "DEEPLAB.model", "deeplabv3plus_embedding_resnet101",
                   "FEWSHOT.variant", "distillation_feature")
    teacher, student = main_distillation.build_models(
        cfg, torch.device("cpu"))
    t_state, s_state = teacher.state_dict(), student.state_dict()
    for key, value in s_state.items():
        if not key.startswith("classifier.classifier.3."):
            assert torch.equal(value, t_state[key]), key
    assert not teacher.training and student.training
    out = main_distillation.main(cfg, torch.float32, max_steps=2,
                                 device="cpu", log_every=1)
    assert out["steps"] == 2
    assert all(np.isfinite(e["loss"]) for e in out["log"])
    assert os.path.exists(out["path"])
