"""Cityscapes dataset with the open-world "unknown class" remap.

Counterpart of the JAX package's ``data/cityscapes.py`` (after the
reference's ``datasets/cityscapes.py``). The 34-id -> 19-train-id table is
applied first; then the classes in ``unknown_target`` (default (14, 15),
truck and bus) are removed, every higher train id is compacted downward
and the removed classes map to 255 (``encode_target``). ``__getitem__``
returns (image, target, target_true): ``target`` with the remap,
``target_true`` with the 19-class mapping only.

Custom splits (``test_car``, ``*_1_shot``, ``*_5_shot``, ``car_100`` ...)
are directories under leftImg8bit/<split>. The JAX package's list lacks
the 5-shot splits, so its self-distillation and distillation CLIs raise
``ValueError`` for ``FEWSHOT.shots 5`` where they mean to read
``test_car_5_shot``; the port accepts them.

A dataset given a ``seed`` hands its transform a ``random.Random`` per
sample, seeded from (seed, epoch, index): a sample's crop, jitter and flip
do not depend on which loader thread reads it or when. ``set_epoch``
(called by ``data/loader.py batch_iterator``) moves to the next epoch's
draws.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Sequence

import numpy as np
from PIL import Image

# 34-entry id -> train_id table
CITYSCAPES_ID_TO_TRAIN_ID = np.array([
    255, 255, 255, 255, 255, 255, 255,
    0, 1, 255, 255,
    2, 3, 4, 255, 255, 255,
    5, 255, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 255, 255, 16, 17, 18,
], dtype=np.int64)

# the license plate id -1 -> 255, by indexing with -1
_ID_TABLE_WITH_NEG = np.concatenate([CITYSCAPES_ID_TO_TRAIN_ID, [255]])

VALID_SPLITS = ("train", "test_car", "val", "test_truck", "test_bus",
                "test_car_1_shot", "test_truck_1_shot", "test_bus_1_shot",
                "test_car_5_shot", "test_truck_5_shot", "test_bus_5_shot",
                "car_vis", "bus_vis", "demo_video", "car_100", "car_1000")

DEFAULT_UNKNOWN_TARGET = (14, 15)  # truck, bus


def encode_target(target, unknown_target: Optional[Sequence[int]] =
                  DEFAULT_UNKNOWN_TARGET):
    """(target, target_true) with the unknown remap.

    For each unknown train id h, in ascending order with the shift already
    made (``cont``): its pixels -> 255, and every higher id shifts down by
    one.
    """
    target = _ID_TABLE_WITH_NEG[np.array(target)]
    target_true = target.copy()
    if unknown_target is not None:
        cont = 0
        for h_c in unknown_target:
            target[target == h_c - cont] = 100
            for c in range(h_c - cont + 1, 19):
                target[target == c] = c - 1
            cont += 1
        target[target == 100] = 255
    return target, target_true


TRAIN_ID_TO_COLOR = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32), (0, 0, 0),
])


def decode_target(target):
    target = np.array(target)
    target[target == 255] = 19
    return TRAIN_ID_TO_COLOR[target]


class Cityscapes:
    """File-tree scanner + joint transform + open-world label encoding."""

    def __init__(self, root: str, split: str = "train", mode: str = "fine",
                 target_type: str = "semantic", transform=None,
                 unknown_target: Optional[Sequence[int]] =
                 DEFAULT_UNKNOWN_TARGET, seed: Optional[int] = None):
        if split not in VALID_SPLITS:
            raise ValueError(f"Invalid split {split}")
        self.root = os.path.expanduser(root)
        self.images_dir = os.path.join(self.root, "leftImg8bit", split)
        self.targets_dir = os.path.join(self.root, "gtFine", split)
        self.transform = transform
        self.unknown_target = unknown_target
        self.seed = seed
        self.epoch = 0

        if not os.path.isdir(self.images_dir) or \
                not os.path.isdir(self.targets_dir):
            raise RuntimeError(
                "Dataset not found or incomplete under " + self.root)

        self.images, self.targets = [], []
        for city in sorted(os.listdir(self.images_dir)):
            img_dir = os.path.join(self.images_dir, city)
            tgt_dir = os.path.join(self.targets_dir, city)
            for file_name in sorted(os.listdir(img_dir)):
                self.images.append(os.path.join(img_dir, file_name))
                base = file_name.split("_leftImg8bit")[0]
                self.targets.append(
                    os.path.join(tgt_dir, f"{base}_gtFine_labelIds.png"))

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
        image = Image.open(self.images[index]).convert("RGB")
        target = Image.open(self.targets[index])
        if self.transform:
            image, target = self.transform(image, target,
                                           self.sample_rng(index))
        target, target_true = encode_target(target, self.unknown_target)
        return image, target, target_true

    encode_target = staticmethod(encode_target)
    decode_target = staticmethod(decode_target)
