"""Joint image + label transforms of the eval (host-side PIL/numpy).

Counterpart of the JAX package's ``data/transforms.py`` (after the
reference's ``utils/ext_transforms.py``): the val transform
``ExtCompose([ExtToTensor(), ExtNormalize()])``. ``ExtToTensor`` gives a
numpy HWC float32 image (not torch CHW; the models take NHWC) and an
integer label; ``ExtNormalize`` works on the last axis. The train
transforms (random crop, colour jitter, flips, scales) wait for DeepLab
training (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class ExtCompose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, lbl):
        for t in self.transforms:
            img, lbl = t(img, lbl)
        return img, lbl


class ExtToTensor:
    """PIL -> numpy: image HWC float32 in [0, 1] (or raw with
    normalize=False), label HW of ``target_type``."""

    def __init__(self, normalize=True, target_type="uint8"):
        self.normalize = normalize
        self.target_type = target_type

    def __call__(self, pic, lbl):
        lbl_arr = np.array(lbl, dtype=self.target_type)
        img = np.asarray(pic, dtype=np.float32)
        if self.normalize:
            img = img / 255.0
        return img, lbl_arr


class ExtNormalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, tensor, lbl):
        return (tensor - self.mean) / self.std, lbl
