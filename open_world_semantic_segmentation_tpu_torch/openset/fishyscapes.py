"""Fishyscapes Lost&Found adapter (the JAX package's
``openset/fishyscapes.py``; the reference's test_eva.py:283-310, 436-442).

``make_estimator`` wraps a model as the benchmark's ``estimator(image) ->
anomaly map`` callable: the host normalises the uint8 image in float32,
the forward and the score run on the model's device. ``run_native``
computes the Fishyscapes pooled-pixel AP / AUROC / FPR95 over an odgt list
without the external harness; ``run_bdlb`` feeds the estimator to
``bdlb`` where that package is installed and raises a clear error where
it is not.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch
from PIL import Image

from ..metrics.anom import get_measures
from .scoring import dissum_conf, msp_conf


def make_estimator(model, *, method: str = "dissum",
                   dtype=torch.float32, mean=(0.485, 0.456, 0.406),
                   std=(0.229, 0.224, 0.225)) -> Callable:
    """uint8 HWC image -> float32 HW anomaly map (higher = more anomalous)
    as numpy. ``method``: ``entropy`` (the reference's softmax entropy),
    ``msp`` (1 - max softmax) or ``dissum`` (negated: the scoring
    convention is lower = more anomalous). ``dtype`` bfloat16 runs the
    forward under autocast; the score is taken in the logits' dtype, as
    the JAX package takes it in the model's."""
    if method not in ("entropy", "msp", "dissum"):
        raise ValueError(f"unknown estimator method {method!r}")
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def fwd(image):
        with torch.autocast(dev.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            out = model(image)
        if isinstance(out, dict):
            scores = out["scores"][0]
        elif isinstance(out, tuple):
            scores = out[0][0]
        else:
            scores = out[0]
        if method == "entropy":
            p = torch.softmax(scores, dim=-1)
            return -(p * torch.log(p + 1e-12)).sum(dim=-1)
        if method == "msp":
            return 1.0 - msp_conf(scores)
        return -dissum_conf(scores)

    def estimator(image) -> np.ndarray:
        arr = np.asarray(image).astype(np.float32) / 255.0
        arr = (arr - mean) / std
        x = torch.from_numpy(arr[None]).to(dev)
        return fwd(x).float().cpu().numpy()

    return estimator


def _read_records(odgt_list):
    """An odgt list: a path to a one-line JSON array or to one JSON record
    per line, or the records themselves."""
    if not isinstance(odgt_list, str):
        return list(odgt_list)
    with open(odgt_list) as f:
        first = f.read(1)
        f.seek(0)
        return (json.load(f) if first == "[" else
                [json.loads(line) for line in f if line.strip()])


def run_native(estimator, root, odgt_list, *, anomaly_id: int = 1,
               min_label: int = 0, max_images=None):
    """Lost&Found without the external harness (the Fishyscapes protocol):
    every odgt-listed image through ``estimator``, AP and AUROC over the
    pixels of the whole set pooled. Labels follow the odgt convention (the
    -1 shift): pixels below ``min_label`` are void, ``anomaly_id`` marks
    the anomaly (raw labelId 2, lost cargo, is 1 after the shift). A score
    map of another size than the label is resized to it (PIL bilinear).

    Returns ``{"AP", "AUROC", "FPR95", "n_images"}``. The pools hold about
    5 bytes per pixel; ``max_images`` bounds them."""
    records = _read_records(odgt_list)
    if max_images is not None:
        records = records[:max_images]
    score_pool, label_pool = [], []
    for rec in records:
        img = np.asarray(Image.open(
            os.path.join(root, rec["fpath_img"])).convert("RGB"))
        segm = np.asarray(Image.open(
            os.path.join(root, rec["fpath_segm"])), dtype=np.int32) - 1
        score = np.asarray(estimator(img))
        if score.ndim == 3:
            score = score[0]
        if score.shape != segm.shape:
            score = np.asarray(Image.fromarray(
                score.astype(np.float32), mode="F").resize(
                (segm.shape[1], segm.shape[0]), Image.BILINEAR))
        valid = segm >= min_label
        score_pool.append(score[valid].astype(np.float32))
        label_pool.append(segm[valid] == anomaly_id)
    scores = np.concatenate(score_pool)
    labels = np.concatenate(label_pool)
    auroc, aupr, fpr = get_measures(scores[labels], scores[~labels])
    return {"AP": float(aupr), "AUROC": float(auroc), "FPR95": float(fpr),
            "n_images": len(records)}


def run_bdlb(estimator, download_dir=None):
    """The external Fishyscapes harness (``bdlb`` with TensorFlow) on
    ``estimator``; ``RuntimeError`` where ``bdlb`` is not installed."""
    try:
        import bdlb
    except ImportError as e:
        raise RuntimeError(
            "the Fishyscapes harness needs the external 'bdlb' package "
            "(not bundled; see fishyscapes.com)") from e
    fs = bdlb.load(benchmark="fishyscapes")
    data = fs.get_dataset("LostAndFound", download_dir=download_dir) \
        if download_dir else fs.get_dataset("LostAndFound")
    import tensorflow as tf  # bdlb dependency

    def tf_estimator(image):
        return tf.convert_to_tensor(estimator(image.numpy()))

    return fs.evaluate(tf_estimator, data)
