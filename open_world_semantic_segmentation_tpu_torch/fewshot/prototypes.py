"""Novel-prototype matching (NPM): extraction, storage and inference.

Counterpart of the JAX package's ``fewshot/prototypes.py`` (after the
reference's ``test_embedding.py``). Each function runs on the tensors'
device, in the same pass as the forward.

- Extraction: for a support image whose ground truth holds the novel class
  over more than ``min_area`` of the image, the prototype is the mean
  embedding over those pixels. The sums are taken in float32 whatever the
  features' dtype. Over data-parallel ranks (``group``) the masked sum, the
  novel pixel count and the pixel count are summed across the ranks in one
  all-reduce before the division and the ``min_area`` test, as the JAX
  package's ``psum`` does.
- Inference: ``dis = -||f_p - proto||^2`` per pixel; a pixel takes the novel
  id where ``dis > threshold`` (-1.5) and ``dis > maxlogit`` (the base
  head's best distance logit).
- Label remap for the 16+1 eval: ground-truth car (13) -> 16, higher ids
  shift down by one, 254 -> 255.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.distance import prototype_distance


def extract_prototype(features: torch.Tensor, labels: torch.Tensor,
                      novel_class: int, min_area: float = 0.05, group=None):
    """Masked-mean embedding of the novel-class pixels.

    features: (B, H, W, C); labels: (B, H, W). Returns (proto (C,) float32,
    valid), ``valid`` a 0-d bool tensor, False where the class covers no
    more than ``min_area`` of the batch (the reference skips such support
    images). Nothing is read back to the host. With ``group`` the batch is
    the union of every rank's (each rank gets the same result).
    """
    mask = (labels == novel_class).float()
    total = mask.sum()
    summed = (features.float() * mask[..., None]).sum((0, 1, 2))
    if group is None:
        count = float(labels.numel())
    else:
        sums = torch.cat([summed, total[None],
                          torch.full((1,), float(labels.numel()),
                                     device=summed.device)])
        dist.all_reduce(sums, group=group)
        summed, total, count = sums[:-2], sums[-2], sums[-1]
    proto = summed / total.clamp(min=1.0)
    valid = total / count > min_area
    return proto, valid


def average_prototypes(protos: Sequence[np.ndarray]) -> np.ndarray:
    """k-shot prototype: the mean of the per-shot prototypes (summed in
    float64)."""
    acc = np.zeros_like(np.asarray(protos[0], dtype=np.float64))
    for p in protos:
        acc += np.asarray(p, dtype=np.float64)
    return (acc / len(protos)).astype(np.float32)


def load_prototypes(path: str) -> np.ndarray:
    """Load a prototype_*.json list of per-shot vectors and average them."""
    with open(path, "r") as f:
        protos = json.load(f)
    return average_prototypes([np.asarray(p, np.float32) for p in protos])


def save_prototypes(path: str, protos: Sequence[np.ndarray]):
    """Write the reference's JSON: a list of per-shot vectors."""
    with open(path, "w") as f:
        json.dump([np.asarray(p).tolist() for p in protos], f)


def npm_override(preds: torch.Tensor, features: torch.Tensor,
                 logits: torch.Tensor, prototype, *, novel_id: int,
                 dis_threshold: float = -1.5):
    """Relabel pixels as ``novel_id`` where the prototype distance beats
    both the threshold and the base head's largest logit. Returns
    (predictions, dis).

    preds: (H, W) int; features: (H, W, C); logits: (H, W, K); prototype
    (C,), float32 for the JAX package's promotion (bf16 features give a
    float32 ``dis``).
    """
    dis = prototype_distance(features, prototype)
    maxlogit = logits.max(-1).values
    take = (dis > dis_threshold) & (dis > maxlogit)
    return torch.where(take, novel_id, preds), dis


def npm_label_remap(labels: torch.Tensor, *, novel_train_id: int = 13,
                    novel_id: int = 16):
    """Ground-truth remap for the 16+1 eval: car (13) -> 16, ids above it
    shift down by one, 254 -> 255."""
    out = torch.where(labels == novel_train_id, -1, labels)
    out = torch.where(out >= novel_train_id + 1, out - 1, out)
    out = torch.where(out == -1, novel_id, out)
    return torch.where(out == 254, 255, out)
