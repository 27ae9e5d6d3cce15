"""PASCAL VOC in the port (``data/voc.py``, ``cli/main_deeplab``
``DEEPLAB.dataset voc``) against the JAX package's, on a synthetic
VOCdevkit tree made here from a numpy seed: JPEG photos of four sizes,
PNG labels of VOC's 21 classes with 255 borders, a ``train_aug`` list
(labels under ``SegmentationClassAug``) and a ``val`` list
(``SegmentationClass``).

- ``VOCSegmentation``'s items equal the JAX package's, bare and through
  the val transform, and ``voc_cmap`` is equal;
- VOC's train transform (random scale, pad-if-needed crop, flip) draws as
  the JAX package's: ``random.Random(s)`` here against ``random.seed(s)``
  there gives the same arrays;
- the val loader batches VOC's images of differing sizes as the JAX
  package's does: one per batch at the default ``val_batch_size`` 1, and a
  batch of two such images fails in both;
- ``cli/main_deeplab.main`` trains deeplabv3plus_mobilenet (21 classes,
  crop 32) for 2 steps on the CPU and validates over the differing sizes.
"""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from open_world_semantic_segmentation_tpu.cli import (
    main_deeplab as jax_main_deeplab)
from open_world_semantic_segmentation_tpu.data import loader as jloader
from open_world_semantic_segmentation_tpu.data import voc as jvoc
from open_world_semantic_segmentation_tpu_torch.cli import main_deeplab
from open_world_semantic_segmentation_tpu_torch.core.config import (
    load_config)
from open_world_semantic_segmentation_tpu_torch.data import loader
from open_world_semantic_segmentation_tpu_torch.data import voc

SIZES = ((40, 56), (56, 40), (48, 64), (36, 48))   # (H, W)


def write_voc_tree(root, n_train=4, n_val=3, seed=0):
    """A VOCdevkit tree; image i has SIZES[i % 4]."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "VOCdevkit", "VOC2012")
    for sub in ("JPEGImages", "SegmentationClass", "SegmentationClassAug",
                "ImageSets/Segmentation"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    splits = {"train_aug": [f"2012_{i:06d}" for i in range(n_train)],
              "val": [f"2011_{i:06d}" for i in range(n_val)]}
    for split, names in splits.items():
        labels = "SegmentationClassAug" if split == "train_aug" else \
            "SegmentationClass"
        for i, name in enumerate(names):
            h, w = SIZES[i % len(SIZES)]
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            lab = np.zeros((h, w), np.uint8)
            for _ in range(3):
                r0, c0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
                lab[r0:r0 + rng.integers(4, h // 2),
                    c0:c0 + rng.integers(4, w // 2)] = rng.integers(1, 21)
            lab[np.roll(lab, 1, 0) != lab] = 255       # object borders
            Image.fromarray(img).save(
                os.path.join(base, "JPEGImages", name + ".jpg"))
            Image.fromarray(lab, "L").save(
                os.path.join(base, labels, name + ".png"))
        with open(os.path.join(base, "ImageSets/Segmentation",
                               split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return write_voc_tree(str(tmp_path_factory.mktemp("voc")))


def test_voc_cmap_matches_jax():
    np.testing.assert_array_equal(voc.voc_cmap(), jvoc.voc_cmap())
    np.testing.assert_array_equal(voc.voc_cmap(normalized=True),
                                  jvoc.voc_cmap(normalized=True))
    np.testing.assert_array_equal(voc.VOCSegmentation.decode_target(
        np.arange(22)), jvoc.VOCSegmentation.decode_target(np.arange(22)))


@pytest.mark.parametrize("image_set", ["train_aug", "val"])
def test_items_match_jax(voc_root, image_set):
    got = voc.VOCSegmentation(voc_root, image_set=image_set)
    want = jvoc.VOCSegmentation(voc_root, image_set=image_set)
    assert len(got) == len(want) > 0
    _, val_tf = main_deeplab.get_transforms(32, "voc")
    _, jval_tf = jax_main_deeplab.get_transforms(32, "voc")
    for i in range(len(got)):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        img, lbl, _ = got[i]
        g_img, g_lbl = val_tf(img, Image.fromarray(lbl))
        w_img, w_lbl = jval_tf(img, Image.fromarray(lbl))
        np.testing.assert_array_equal(g_img, w_img)
        np.testing.assert_array_equal(g_lbl, w_lbl)


def test_train_transform_matches_jax(voc_root):
    ds = voc.VOCSegmentation(voc_root, image_set="train_aug")
    train_tf, _ = main_deeplab.get_transforms(48, "voc")
    jtrain_tf, _ = jax_main_deeplab.get_transforms(48, "voc")
    for i in range(len(ds)):
        img, lbl, _ = ds[i]
        for seed in (0, 1, 2):
            g = train_tf(img, Image.fromarray(lbl), random.Random(seed))
            random.seed(seed)
            w = jtrain_tf(img, Image.fromarray(lbl))
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
            assert g[0].shape[:2] == g[1].shape == (48, 48)


def test_val_loader_batches_as_jax(voc_root):
    cfg = load_config(None, ["DATASET.root_dataset", voc_root,
                             "DEEPLAB.dataset", "voc"])
    _, val_tf = main_deeplab.get_transforms(32, "voc")
    ds = main_deeplab.get_val_dataset(cfg, val_tf)
    _, jval_tf = jax_main_deeplab.get_transforms(32, "voc")
    jds = jvoc.VOCSegmentation(voc_root, image_set="val", transform=jval_tf)
    kw = dict(shuffle=False, drop_last=False, epochs=1)
    got = list(loader.batch_iterator(ds, 1, **kw))
    want = list(jloader.batch_iterator(jds, 1, **kw))
    assert len(got) == len(want) == len(ds)
    assert len({b[0].shape for b in got}) > 1      # sizes differ
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for it in (loader.batch_iterator(ds, 2, **kw),
               jloader.batch_iterator(jds, 2, **kw)):
        with pytest.raises(ValueError):
            next(it)


def test_main_deeplab_trains_on_voc(voc_root, tmp_path):
    cfg = load_config(None, [
        "DATASET.root_dataset", voc_root, "DEEPLAB.dataset", "voc",
        "DEEPLAB.model", "deeplabv3plus_mobilenet",
        "DEEPLAB.num_classes", "21", "DEEPLAB.crop_size", "32",
        "DEEPLAB.batch_size", "2", "DEEPLAB.total_itrs", "2",
        "DEEPLAB.val_interval", "2", "DEEPLAB.lr", "0.01",
        "DIR", str(tmp_path)])
    torch.manual_seed(0)
    out = main_deeplab.main(cfg, torch.float32, device="cpu", log_every=1)
    assert out["steps"] == 2 and out["skipped"] == 0
    assert all(np.isfinite(e["loss"]) for e in out["log"])
    assert len(out["validations"]) == 1
    assert 0.0 <= out["validations"][0] <= 1.0
    assert os.path.exists(tmp_path / "latest.pth")
    with pytest.raises(ValueError, match="train_aug"):
        main_deeplab.get_train_dataset(cfg, None, "test_car_5_shot")
