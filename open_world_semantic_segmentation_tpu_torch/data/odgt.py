"""odgt-list eval pipeline (StreetHazards / BDD / Lost&Found), host side.

numpy/PIL re-implementation of the reference's ``anomaly/dataset.py`` eval
path, the same as the JAX package's ``data/odgt.py`` ``ValPipeline`` on its
PIL path:

- records ``{fpath_img, fpath_segm, height, width}`` parsed from a one-line
  JSON array;
- ImageNet normalisation, labels shifted by -1;
- a per-image pyramid of all ``img_sizes`` resizes (PIL bilinear), each
  rounded up to the padding multiple, plus the untouched label.

Items are numpy arrays in NHWC; the evaluator moves them to the device.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def parse_odgt(odgt, max_sample: int = -1) -> List[dict]:
    if isinstance(odgt, list):
        records = odgt
    else:
        with open(odgt, "r") as f:
            records = [json.loads(x.rstrip()) for x in f][0]
    if max_sample > 0:
        records = records[:max_sample]
    if not records:
        raise ValueError(f"no records in {odgt!r}")
    return records


def img_transform(img: Image.Image) -> np.ndarray:
    """PIL RGB -> normalized float32 HWC."""
    arr = np.float32(np.array(img)) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def segm_transform(segm) -> np.ndarray:
    """label png -> int32 HW, values shifted to -1..C-1."""
    return np.array(segm, dtype=np.int32) - 1


def round2nearest_multiple(x: int, p: int) -> int:
    return ((x - 1) // p + 1) * p


def eval_pyramid_shapes(src_h: int, src_w: int,
                        img_sizes=(300, 375, 450, 525, 600),
                        img_max_size: int = 1000,
                        padding_constant: int = 8):
    """(h, w) of each eval-pyramid scale for a source image: short edge to
    each of ``img_sizes`` capped by ``img_max_size`` on the long edge,
    both rounded up to ``padding_constant``."""
    shapes = []
    for short in img_sizes:
        scale = min(short / float(min(src_h, src_w)),
                    img_max_size / float(max(src_h, src_w)))
        shapes.append((round2nearest_multiple(int(src_h * scale),
                                              padding_constant),
                       round2nearest_multiple(int(src_w * scale),
                                              padding_constant)))
    return shapes


class ValPipeline:
    """Sequential iterator of per-image multi-scale eval items.

    Each item holds ``seg_label`` (1, H, W) int32, ``info``, ``name``,
    ``img_ori`` and ``img_data``, the pyramid: a list of (1, h, w, 3)
    float32 arrays.
    """

    def __init__(self, root_dataset: str, odgt, *,
                 img_sizes=(300, 375, 450, 525, 600), img_max_size=1000,
                 padding_constant=8, max_sample: int = -1):
        self.root = root_dataset
        self.records = parse_odgt(odgt, max_sample)
        self.img_sizes = tuple(img_sizes)
        self.img_max_size = img_max_size
        self.padding_constant = padding_constant

    def __len__(self):
        return len(self.records)

    def __getitem__(self, index: int) -> dict:
        rec = self.records[index]
        segm = Image.open(os.path.join(self.root, rec["fpath_segm"]))
        img = Image.open(os.path.join(self.root, rec["fpath_img"]))
        img = img.convert("RGB")
        if segm.mode != "L" or img.size != segm.size:
            raise ValueError(f"{rec['fpath_segm']}: label must be an L-mode "
                             "image of the photo's size")

        ow, oh = img.size
        shapes = eval_pyramid_shapes(oh, ow, self.img_sizes,
                                     self.img_max_size,
                                     self.padding_constant)
        return {
            "seg_label": segm_transform(segm)[None],
            "info": rec["fpath_img"],
            "name": os.path.join(*rec["fpath_img"].split("/")[-2:]),
            "img_ori": np.array(img),
            "img_data": [
                img_transform(img.resize((tw, th), Image.BILINEAR))[None]
                for th, tw in shapes],
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
