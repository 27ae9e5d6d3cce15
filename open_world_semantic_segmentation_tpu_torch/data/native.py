"""ctypes binding of the native host-preprocessing library.

``native/image_ops.cpp`` (at the root of the checkout) provides threaded,
PIL-parity resampling with the ImageNet normalisation fused in. It is
compiled with g++ at first use, with the flags of ``native/Makefile``, into
the port's build directory (``ops/_build.py``), and loaded with ctypes.
Where it cannot be built or loaded, every function here raises with the
reason; there is no quiet fall back to PIL (the JAX package's binding has
one).

- ``resize_normalize``: uint8 HWC -> PIL-BILINEAR-resized, normalised
  float32 HWC;
- ``resize_label``: uint8 HW label map -> PIL-NEAREST-resized int32 plus an
  offset;
- ``normalize``: uint8 HWC -> normalised float32 HWC.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import platform
import shutil
from pathlib import Path
from typing import Tuple

import numpy as np

from ..ops import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "image_ops.cpp"
# native/Makefile's CXXFLAGS; -march=native: the library is built on, and
# for, the host that runs it
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared")

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


@functools.cache
def load() -> ctypes.CDLL:
    """Build (at first use) and load the library; raise with the reason
    where that fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"native image ops: {SOURCE} not found (the "
                           "library is built from the repository checkout)")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native image ops: g++ not found")
    # the host's name is in the key: -march=native code is the host's own
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + (platform.node(),)).encode()).hexdigest()[:16]
    path = _build.compile_library(
        [cxx, *CXX_FLAGS], SOURCE,
        _build.BUILD_DIR / f"image_ops-{digest}.so")
    lib = ctypes.CDLL(str(path))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_int = ctypes.c_int
    lib.resize_bilinear_normalize_u8.argtypes = [
        u8p, c_int, c_int, f32p, c_int, c_int, f32p, f32p]
    lib.resize_nearest_label.argtypes = [
        u8p, c_int, c_int, i32p, c_int, c_int, c_int]
    lib.normalize_u8.argtypes = [u8p, c_int, c_int, f32p, f32p, f32p]
    for fn in (lib.resize_bilinear_normalize_u8, lib.resize_nearest_label,
               lib.normalize_u8):
        fn.restype = None
    return lib


def _image(img_u8: np.ndarray, ndim: int) -> np.ndarray:
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img_u8.ndim != ndim or (ndim == 3 and img_u8.shape[2] != 3):
        raise ValueError(f"expected a {'HWC RGB' if ndim == 3 else 'HW'} "
                         f"uint8 array, got shape {img_u8.shape}")
    return img_u8


def _stats(mean, std):
    return (np.ascontiguousarray(mean, np.float32),
            np.ascontiguousarray(std, np.float32))


def resize_normalize(img_u8: np.ndarray, size_hw: Tuple[int, int],
                     mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """uint8 HWC image -> PIL-BILINEAR-resized, normalised float32 HWC."""
    lib = load()
    img_u8 = _image(img_u8, 3)
    dh, dw = int(size_hw[0]), int(size_hw[1])
    out = np.empty((dh, dw, 3), np.float32)
    lib.resize_bilinear_normalize_u8(img_u8, img_u8.shape[0],
                                     img_u8.shape[1], out, dh, dw,
                                     *_stats(mean, std))
    return out


def resize_label(lab_u8: np.ndarray, size_hw: Tuple[int, int],
                 offset: int = -1) -> np.ndarray:
    """uint8 HW label map -> PIL-NEAREST-resized int32 HW plus offset."""
    lib = load()
    lab_u8 = _image(lab_u8, 2)
    dh, dw = int(size_hw[0]), int(size_hw[1])
    out = np.empty((dh, dw), np.int32)
    lib.resize_nearest_label(lab_u8, lab_u8.shape[0], lab_u8.shape[1], out,
                             dh, dw, offset)
    return out


def normalize(img_u8: np.ndarray, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> np.ndarray:
    """uint8 HWC image -> normalised float32 HWC."""
    lib = load()
    img_u8 = _image(img_u8, 3)
    h, w = img_u8.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    lib.normalize_u8(img_u8, h, w, out, *_stats(mean, std))
    return out
