"""Visualisation helpers: denormalisation and result grids, on the host.

The JAX package's ``utils/visualize.py`` (numpy and PIL only): the
reference's visdom dashboard and matplotlib dumps
(utils/visualizer.py, eval_ood_traditional.py:112-126) become plain PNGs.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from ..data.odgt import IMAGENET_MEAN, IMAGENET_STD
from .colors import STREETHAZARDS_COLORS, color_encode


class Denormalize:
    """Invert ImageNet normalisation on a CHW or HWC float image."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, tensor):
        arr = np.asarray(tensor, dtype=np.float32)
        if arr.ndim == 3 and arr.shape[0] == 3:  # CHW
            return arr * self.std[:, None, None] + self.mean[:, None, None]
        return arr * self.std + self.mean


def save_result_grid(img, seg, pred, info, dir_result,
                     colors=STREETHAZARDS_COLORS):
    """Save the [image | gt | pred] PNG of one image as
    ``dir_result/<name>.png`` (``info``'s last path part, ``.jpg`` made
    ``.png``), as the reference's visualize_result does."""
    seg_color = color_encode(seg, colors)
    pred_color = color_encode(pred, colors)
    im_vis = np.concatenate((np.asarray(img), seg_color, pred_color),
                            axis=1).astype(np.uint8)
    img_name = info.split("/")[-1]
    os.makedirs(dir_result, exist_ok=True)
    Image.fromarray(im_vis).save(
        os.path.join(dir_result, img_name.replace(".jpg", ".png")))
