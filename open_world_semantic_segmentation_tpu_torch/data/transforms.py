"""Joint image + label transforms (host-side PIL/numpy).

Counterpart of the JAX package's ``data/transforms.py`` (after the
reference's ``utils/ext_transforms.py``): every geometric op is applied
alike to the image (bilinear) and the label (nearest), and the label stays
integer. ``ExtToTensor`` gives a numpy HWC float32 image (not torch CHW;
the models take NHWC) and an integer label; ``ExtNormalize`` works on the
last axis. Colour jitter follows torchvision: factors drawn uniformly from
[max(0, 1 - x), 1 + x], applied in a random order through PIL's
``ImageEnhance``.

Randomness: the JAX package's transforms draw from Python's global
``random`` module; here every transform is called as ``t(img, lbl, rng)``
with an explicit ``random.Random``, and makes the same draws from it in
the same order (so ``random.seed(s)`` there and ``random.Random(s)`` here
give the same output). A random transform raises without one; the others
ignore it. ``data/cityscapes.py`` gives each training sample its own
generator.

The reference's train recipes (main.py:132-147):
  cityscapes: ExtRandomCrop(768|513) -> ExtColorJitter(.5,.5,.5) ->
              ExtRandomHorizontalFlip -> ExtToTensor -> ExtNormalize
  voc:        ExtRandomScale((0.5, 2.0)) -> ExtRandomCrop(513, pad_if_needed)
              -> ExtRandomHorizontalFlip -> ExtToTensor -> ExtNormalize
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _need(rng: Optional[random.Random], what) -> random.Random:
    if rng is None:
        raise ValueError(f"{type(what).__name__} draws random numbers: "
                         "call it with a random.Random")
    return rng


class ExtCompose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, lbl, rng: Optional[random.Random] = None):
        for t in self.transforms:
            img, lbl = t(img, lbl, rng)
        return img, lbl


class ExtRandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, lbl, rng=None):
        if _need(rng, self).random() < self.p:
            return (img.transpose(Image.FLIP_LEFT_RIGHT),
                    lbl.transpose(Image.FLIP_LEFT_RIGHT))
        return img, lbl


class ExtRandomVerticalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, lbl, rng=None):
        if _need(rng, self).random() < self.p:
            return (img.transpose(Image.FLIP_TOP_BOTTOM),
                    lbl.transpose(Image.FLIP_TOP_BOTTOM))
        return img, lbl


class ExtCenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else size

    def __call__(self, img, lbl, rng=None):
        th, tw = self.size
        w, h = img.size
        left = int(round((w - tw) / 2.0))
        top = int(round((h - th) / 2.0))
        box = (left, top, left + tw, top + th)
        return img.crop(box), lbl.crop(box)


def _check_sizes(img, lbl):
    if img.size != lbl.size:
        raise ValueError(f"size of img and lbl should be the same. "
                         f"{img.size}, {lbl.size}")


def _scaled(img, lbl, scale, interpolation):
    target = (int(img.size[0] * scale), int(img.size[1] * scale))
    return (img.resize(target, interpolation),
            lbl.resize(target, Image.NEAREST))


class ExtRandomScale:
    def __init__(self, scale_range, interpolation=Image.BILINEAR):
        self.scale_range = scale_range
        self.interpolation = interpolation

    def __call__(self, img, lbl, rng=None):
        _check_sizes(img, lbl)
        scale = _need(rng, self).uniform(self.scale_range[0],
                                         self.scale_range[1])
        return _scaled(img, lbl, scale, self.interpolation)


class ExtScale:
    def __init__(self, scale, interpolation=Image.BILINEAR):
        self.scale = scale
        self.interpolation = interpolation

    def __call__(self, img, lbl, rng=None):
        _check_sizes(img, lbl)
        return _scaled(img, lbl, self.scale, self.interpolation)


class ExtResize:
    """int size: the shorter edge to ``size``; tuple: exactly (h, w)."""

    def __init__(self, size, interpolation=Image.BILINEAR):
        self.size = size
        self.interpolation = interpolation

    def _target(self, img):
        if isinstance(self.size, int):
            w, h = img.size
            if w < h:
                return (self.size, int(self.size * h / w))
            return (int(self.size * w / h), self.size)
        return (self.size[1], self.size[0])

    def __call__(self, img, lbl, rng=None):
        t = self._target(img)
        return (img.resize(t, self.interpolation),
                lbl.resize(t, Image.NEAREST))


def _pil_pad(img, padding, fill=0):
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    return ImageOps.expand(img, border=padding, fill=fill)


class ExtRandomCrop:
    """ext_transforms.py:328-396: optional fixed padding, optional
    pad-if-needed by half the deficit, then a uniform random crop."""

    def __init__(self, size, padding=0, pad_if_needed=False):
        self.size = (int(size), int(size)) if isinstance(size, (int, float)) \
            else size
        self.padding = padding
        self.pad_if_needed = pad_if_needed

    @staticmethod
    def get_params(img, output_size, rng: random.Random):
        w, h = img.size
        th, tw = output_size
        if w == tw and h == th:
            return 0, 0, h, w
        i = rng.randint(0, h - th)
        j = rng.randint(0, w - tw)
        return i, j, th, tw

    def __call__(self, img, lbl, rng=None):
        _check_sizes(img, lbl)
        if self.padding > 0:
            img = _pil_pad(img, self.padding)
            lbl = _pil_pad(lbl, self.padding)
        if self.pad_if_needed and img.size[0] < self.size[1]:
            p = int((1 + self.size[1] - img.size[0]) / 2)
            img, lbl = _pil_pad(img, p), _pil_pad(lbl, p)
        if self.pad_if_needed and img.size[1] < self.size[0]:
            p = int((1 + self.size[0] - img.size[1]) / 2)
            img, lbl = _pil_pad(img, p), _pil_pad(lbl, p)
        i, j, th, tw = self.get_params(img, self.size, _need(rng, self))
        box = (j, i, j + tw, i + th)
        return img.crop(box), lbl.crop(box)


class ExtColorJitter:
    _ENHANCE = {"brightness": ImageEnhance.Brightness,
                "contrast": ImageEnhance.Contrast,
                "saturation": ImageEnhance.Color}

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def get_params(brightness, contrast, saturation, rng: random.Random):
        ops = []
        for name, x in (("brightness", brightness), ("contrast", contrast),
                        ("saturation", saturation)):
            if x > 0:
                ops.append((name, rng.uniform(max(0, 1 - x), 1 + x)))
        rng.shuffle(ops)
        return ops

    def __call__(self, img, lbl, rng=None):
        for name, f in self.get_params(self.brightness, self.contrast,
                                       self.saturation, _need(rng, self)):
            img = self._ENHANCE[name](img).enhance(f)
        return img, lbl


class ExtToTensor:
    """PIL -> numpy: image HWC float32 in [0, 1] (or raw with
    normalize=False), label HW of ``target_type``."""

    def __init__(self, normalize=True, target_type="uint8"):
        self.normalize = normalize
        self.target_type = target_type

    def __call__(self, pic, lbl, rng=None):
        lbl_arr = np.array(lbl, dtype=self.target_type)
        img = np.asarray(pic, dtype=np.float32)
        if self.normalize:
            img = img / 255.0
        return img, lbl_arr


class ExtNormalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, tensor, lbl, rng=None):
        return (tensor - self.mean) / self.std, lbl
