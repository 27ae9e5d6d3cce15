"""PASCAL VOC 2012 segmentation dataset, with the SBD-augmented
``train_aug`` split.

Counterpart of the JAX package's ``data/voc.py`` (after the reference's
``datasets/voc.py``): the VOCdevkit layout under ``root``; the
``train_aug`` split reads its id list from
``ImageSets/Segmentation/train_aug.txt`` and its labels from
``SegmentationClassAug``, every other split from
``ImageSets/Segmentation/<split>.txt`` and ``SegmentationClass``.
``__getitem__`` returns (image, target, target) as the JAX package does
(VOC has no open-world remap). Labels are VOC's 21 classes, 255 on the
object borders (the ignore index).

As ``data/cityscapes.py``, a dataset given a ``seed`` hands its transform
a ``random.Random`` per sample, seeded from (seed, epoch, index), so a
sample's scale, crop and flip do not depend on which loader thread reads
it; ``set_epoch`` moves to the next epoch's draws.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
from PIL import Image


def voc_cmap(N: int = 256, normalized: bool = False):
    """The standard VOC colour map: (N, 3) uint8, or float32 in [0, 1]."""
    def bitget(byteval, idx):
        return (byteval & (1 << idx)) != 0

    dtype = "float32" if normalized else "uint8"
    cmap = np.zeros((N, 3), dtype=dtype)
    for i in range(N):
        r = g = b = 0
        c = i
        for j in range(8):
            r = r | (bitget(c, 0) << 7 - j)
            g = g | (bitget(c, 1) << 7 - j)
            b = b | (bitget(c, 2) << 7 - j)
            c = c >> 3
        cmap[i] = np.array([r, g, b])
    return cmap / 255 if normalized else cmap


class VOCSegmentation:
    """VOC2012 (+aug): (image, target, target) through the joint
    transform. ``root`` holds ``VOCdevkit/VOC<year>``."""

    cmap = voc_cmap()

    def __init__(self, root: str, year: str = "2012",
                 image_set: str = "train", transform=None,
                 seed: Optional[int] = None):
        self.root = os.path.expanduser(root)
        self.transform = transform
        self.seed = seed
        self.epoch = 0
        voc_root = os.path.join(self.root, "VOCdevkit", f"VOC{year}")
        image_dir = os.path.join(voc_root, "JPEGImages")
        if not os.path.isdir(voc_root):
            raise RuntimeError("Dataset not found or corrupted: " + voc_root)
        split_dir = os.path.join(voc_root, "ImageSets", "Segmentation")
        if image_set == "train_aug":
            mask_dir = os.path.join(voc_root, "SegmentationClassAug")
            split_f = os.path.join(split_dir, "train_aug.txt")
        else:
            mask_dir = os.path.join(voc_root, "SegmentationClass")
            split_f = os.path.join(split_dir, image_set.rstrip("\n") + ".txt")
        if not os.path.exists(split_f):
            raise ValueError(f"missing split list {split_f}")
        with open(split_f) as f:
            names = [x.strip() for x in f.readlines()]
        self.images = [os.path.join(image_dir, x + ".jpg") for x in names]
        self.masks = [os.path.join(mask_dir, x + ".png") for x in names]

    def __len__(self):
        return len(self.images)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def sample_rng(self, index) -> Optional[random.Random]:
        """The generator of sample ``index`` in this epoch (None without a
        seed)."""
        if self.seed is None:
            return None
        state = np.random.SeedSequence(
            (self.seed, self.epoch, int(index))).generate_state(2)
        return random.Random(int(state[0]) << 32 | int(state[1]))

    def __getitem__(self, index):
        img = Image.open(self.images[index]).convert("RGB")
        target = Image.open(self.masks[index])
        if self.transform is not None:
            img, target = self.transform(img, target, self.sample_rng(index))
        target = np.array(target)
        return img, target, target.copy()

    @classmethod
    def decode_target(cls, mask):
        return cls.cmap[mask]
