"""odgt-list pipelines (StreetHazards / BDD / Lost&Found), host side.

numpy/PIL re-implementation of the reference's ``anomaly/dataset.py``, the
same as the JAX package's ``data/odgt.py``:

- records ``{fpath_img, fpath_segm, height, width}`` parsed from a one-line
  JSON array;
- ImageNet normalisation, labels shifted by -1;
- ``TrainPipeline``: aspect-ratio-bucketed sub-batches (h > w vs h <= w),
  a random short edge per batch from ``img_sizes`` capped by
  ``img_max_size``, padding to a multiple of ``padding_constant``, labels
  nearest-downsampled by ``segm_downsampling_rate`` after rounding up,
  random horizontal flips; resampling by the native library
  (``data/native.py``, the default) or PIL;
- ``ValPipeline``: a per-image pyramid of all ``img_sizes`` resizes (PIL
  bilinear), each rounded up to the padding multiple, plus the untouched
  label; or, with ``device_pyramid``, the one uint8 image for the device
  to resize; optionally read from a reconstructed tree (``rec_dataset``).

Items are numpy arrays in NHWC; the consumer moves them to the device.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional

import numpy as np
from PIL import Image

from . import native
from ..parallel.mesh import check_shard, shard_index_space

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


def device_normalize(imgs):
    """uint8 NHWC on the device -> ImageNet-normalised float32, on the
    same device. The one definition of the device-side normalisation of
    the server's ``--device-input`` and the evaluator's device pyramid;
    bit for bit ``img_transform`` for uint8 input."""
    import torch

    mean = torch.from_numpy(IMAGENET_MEAN).to(imgs.device)
    std = torch.from_numpy(IMAGENET_STD).to(imgs.device)
    return (imgs.float() / 255.0 - mean) / std


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


def imresize(im: Image.Image, size, interp="bilinear") -> Image.Image:
    """PIL resize to ``size`` = (w, h)."""
    resample = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR}[interp]
    return im.resize(size, resample)


def _host_shard(records, num_hosts: int, host_id: int, seed=None):
    """The records of host ``host_id`` of ``num_hosts``, in its shard's
    order; all of them, as they are, on one host."""
    if num_hosts == 1:
        return records
    idx = shard_index_space(len(records), num_hosts, host_id,
                            shuffle_seed=seed)
    return [records[i] for i in idx]


class TrainPipeline:
    """Infinite iterator of train batches with the reference's bucketing.

    Each batch is ``{"img_data": (B, bh, bw, 3) float32, "seg_label":
    (B, bh / r, bw / r) int32}`` with r the label down-sampling rate. For a
    seed and a tree it yields the JAX package's batches: the same
    ``np.random.default_rng(seed)`` draws in the same order, the same
    resampling (PIL, or the same native library). ``use_native=True`` (the
    default, as in the JAX package) raises where the native library cannot
    be built; there is no quiet switch to PIL.

    With ``num_hosts > 1`` host ``host_id`` keeps its shard of the records
    (``parallel/mesh.py shard_index_space``, shuffled by ``seed``, which
    every host shares) and draws from ``default_rng(seed + host_id)``, as
    the JAX package's pipeline does.
    """

    def __init__(self, root_dataset: str, odgt, *, batch_per_gpu: int = 2,
                 img_sizes=(300, 375, 450, 525, 600), img_max_size=1000,
                 padding_constant=8, segm_downsampling_rate=8,
                 random_flip=True, seed: int = 304, num_hosts: int = 1,
                 host_id: int = 0, use_native: bool = True):
        check_shard(num_hosts, host_id)
        self.native = None
        if use_native:
            self.native = native
            native.load()              # raises here, with the reason
        self.root = root_dataset
        self.records = _host_shard(parse_odgt(odgt), num_hosts, host_id,
                                   seed)
        self.batch_per_gpu = batch_per_gpu
        self.img_sizes = tuple(img_sizes)
        self.img_max_size = img_max_size
        self.padding_constant = padding_constant
        self.segm_down = segm_downsampling_rate
        self.random_flip = random_flip
        self.rng = np.random.default_rng(seed + host_id)
        self._bucket = [[], []]
        self._cursor = 0
        self._order = list(range(len(self.records)))

    def _next_sub_batch(self) -> List[dict]:
        while True:
            rec = self.records[self._order[self._cursor]]
            idx = 0 if rec["height"] > rec["width"] else 1
            self._bucket[idx].append(rec)
            self._cursor += 1
            if self._cursor >= len(self.records):
                self._cursor = 0
                self.rng.shuffle(self._order)
            if len(self._bucket[idx]) == self.batch_per_gpu:
                out = self._bucket[idx]
                self._bucket[idx] = []
                return out

    def _load_pair(self, rec):
        img = Image.open(os.path.join(self.root, rec["fpath_img"]))
        segm = Image.open(os.path.join(self.root, rec["fpath_segm"]))
        img = img.convert("RGB")
        if segm.mode != "L" or img.size != segm.size:
            raise ValueError(f"{rec['fpath_segm']}: label must be an L-mode "
                             "image of the photo's size")
        return img, segm

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def _resample_native(self, img, segm, h, w):
        arr = self.native.resize_normalize(np.asarray(img), (h, w))
        seg_full = self.native.resize_label(np.asarray(segm), (h, w),
                                            offset=0)
        sw = round2nearest_multiple(w, self.segm_down)
        sh = round2nearest_multiple(h, self.segm_down)
        canvas = np.zeros((sh, sw), np.uint8)
        canvas[:seg_full.shape[0], :seg_full.shape[1]] = \
            seg_full.astype(np.uint8)
        seg = self.native.resize_label(
            canvas, (sh // self.segm_down, sw // self.segm_down), offset=-1)
        return arr, seg

    def _resample_pil(self, img, segm, h, w):
        img = imresize(img, (w, h), "bilinear")
        segm = imresize(segm, (w, h), "nearest")
        sw = round2nearest_multiple(segm.size[0], self.segm_down)
        sh = round2nearest_multiple(segm.size[1], self.segm_down)
        canvas = Image.new("L", (sw, sh), 0)
        canvas.paste(segm, (0, 0))
        segm = imresize(canvas, (sw // self.segm_down, sh // self.segm_down),
                        "nearest")
        return img_transform(img), segm_transform(segm)

    def next_batch(self) -> dict:
        records = self._next_sub_batch()
        short = int(self.rng.choice(self.img_sizes))

        widths = np.zeros(self.batch_per_gpu, np.int32)
        heights = np.zeros(self.batch_per_gpu, np.int32)
        for i, rec in enumerate(records):
            h, w = rec["height"], rec["width"]
            scale = min(short / min(h, w), self.img_max_size / max(h, w))
            widths[i] = int(w * scale)
            heights[i] = int(h * scale)
        bw = round2nearest_multiple(int(widths.max()), self.padding_constant)
        bh = round2nearest_multiple(int(heights.max()), self.padding_constant)

        imgs = np.zeros((self.batch_per_gpu, bh, bw, 3), np.float32)
        segs = np.zeros((self.batch_per_gpu, bh // self.segm_down,
                         bw // self.segm_down), np.int32)
        for i, rec in enumerate(records):
            img, segm = self._load_pair(rec)
            if self.random_flip and self.rng.choice([0, 1]):
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                segm = segm.transpose(Image.FLIP_LEFT_RIGHT)
            resample = (self._resample_native if self.native is not None
                        else self._resample_pil)
            arr, seg = resample(img, segm, int(heights[i]), int(widths[i]))
            imgs[i, :arr.shape[0], :arr.shape[1]] = arr
            segs[i, :seg.shape[0], :seg.shape[1]] = seg
        return {"img_data": imgs, "seg_label": segs}


class ValPipeline:
    """Sequential iterator of per-image multi-scale eval items.

    Each item holds ``seg_label`` (1, H, W) int32, ``info``, ``name``,
    ``img_ori`` and either ``img_data``, the pyramid: a list of
    (1, h, w, 3) float32 arrays, or with ``device_pyramid`` the one uint8
    image ``img_raw`` (1, H, W, 3) and its ``pyramid_shapes``: the
    consumer normalises and resizes it on the device
    (``openset/evaluator.py device_pyramid``, the torch-grid bilinear, not
    PIL's filter, so scores deviate from the PIL path within resampling
    tolerance). With ``rec_dataset`` the image is read from that tree,
    matched by its last folder and file name, and resized to the label's
    size (nearest), the reference's reconstructed inputs. With
    ``num_hosts > 1`` host ``host_id`` keeps its contiguous shard of the
    records, unshuffled (``parallel/mesh.py shard_index_space``).
    """

    def __init__(self, root_dataset: str, odgt, *,
                 img_sizes=(300, 375, 450, 525, 600), img_max_size=1000,
                 padding_constant=8, max_sample: int = -1,
                 rec_dataset: Optional[str] = None,
                 device_pyramid: bool = False, num_hosts: int = 1,
                 host_id: int = 0):
        check_shard(num_hosts, host_id)
        self.root = root_dataset
        self.records = _host_shard(parse_odgt(odgt, max_sample), num_hosts,
                                   host_id)
        self.img_sizes = tuple(img_sizes)
        self.img_max_size = img_max_size
        self.padding_constant = padding_constant
        self.rec_dataset = rec_dataset
        self.device_pyramid = device_pyramid

    def __len__(self):
        return len(self.records)

    def __getitem__(self, index: int) -> dict:
        rec = self.records[index]
        if self.rec_dataset:
            folder, image = rec["fpath_img"].split("/")[-2:]
            image_path = os.path.join(self.rec_dataset, folder, image)
        else:
            image_path = os.path.join(self.root, rec["fpath_img"])
        segm = Image.open(os.path.join(self.root, rec["fpath_segm"]))
        img = Image.open(image_path).convert("RGB")
        if self.rec_dataset:
            img = imresize(img, segm.size, "nearest")
        if segm.mode != "L" or img.size != segm.size:
            raise ValueError(f"{rec['fpath_segm']}: label must be an L-mode "
                             "image of the photo's size")

        ow, oh = img.size
        shapes = eval_pyramid_shapes(oh, ow, self.img_sizes,
                                     self.img_max_size,
                                     self.padding_constant)
        out = {
            "seg_label": segm_transform(segm)[None],
            "info": rec["fpath_img"],
            "name": os.path.join(*rec["fpath_img"].split("/")[-2:]),
            "img_ori": np.array(img),
        }
        if self.device_pyramid:
            out["img_raw"] = out["img_ori"][None]
            out["pyramid_shapes"] = tuple(shapes)
            return out
        out["img_data"] = [
            img_transform(img.resize((tw, th), Image.BILINEAR))[None]
            for th, tw in shapes]
        return out

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
