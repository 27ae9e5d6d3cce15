"""DeepLab closed-set eval only (the JAX package's ``cli/test_deeplab.py``;
the reference's main.py --test_only and test.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.test_deeplab \
      DEEPLAB.model deeplabv3plus_resnet101 DEEPLAB.ckpt best.pth

Runs on CUDA unless ``--device cpu`` is given. Evaluates the val split once
and prints ``StreamSegMetrics.to_str``. With an embedding model or
``DEEPLAB.unknown_scores`` it also scores the unknown pixels as an open-set
problem, per image, on the pixels whose 19-class label is not 255:
positives are the remapped-away classes (label 255), the score is 1 - max
softmax, and the mean AUROC / FPR95 / AUPR over the images that hold
unknowns is printed in the reference's order. ``DEEPLAB.save_val_results``
needs ``utils/visualize.py``, which is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import (autocast, build_deeplab_model, double_buffered,
                           get_transforms, get_val_dataset,
                           init_or_load_deeplab, to_host_async)
from ..data.loader import batch_iterator
from ..data.prefetch import iter_prefetch
from ..metrics.anom import get_measures
from ..metrics.segmentation import StreamSegMetrics


def validate(model, val_ds, metrics: StreamSegMetrics, *, dtype,
             batch_size: int = 1, unknown_scores: bool = False,
             max_images=None):
    """One pass over ``val_ds``; returns ``(score, ood or None, clock)``,
    ``clock`` as ``double_buffered`` returns it with ``images``."""
    metrics.reset()
    dev = next(model.parameters()).device
    aucs, auprs, fprs = [], [], []

    @torch.inference_mode()
    def dispatch(batch):
        image, target, target_true = batch
        with autocast(dev, dtype):
            out = model(torch.from_numpy(image).to(dev))
        logits = out[0] if isinstance(out, tuple) else out
        if isinstance(logits, list):
            logits = logits[0]      # self-distillation: the base head
        preds = logits.argmax(-1)
        # 1 - max softmax: the reference's anomaly score
        msp = torch.softmax(logits.float(), -1).max(-1).values
        return len(image), to_host_async([preds, 1.0 - msp]), (
            target, target_true)

    def resolve(arrays, context):
        preds, scores = arrays
        target, target_true = context
        metrics.update(target.astype(np.int64), preds)
        if unknown_scores:
            # only pixels with a 19-class label; positives are the
            # remapped-away classes (255)
            for b in range(len(preds)):
                valid = target_true[b] != 255
                msk = target[b][valid] == 255
                sc = scores[b][valid]
                if msk.any() and (~msk).any():
                    auroc, aupr, fpr = get_measures(sc[msk], sc[~msk])
                    aucs.append(auroc)
                    auprs.append(aupr)
                    fprs.append(fpr)

    batches = batch_iterator(val_ds, batch_size, shuffle=False,
                             drop_last=False, epochs=1)
    n, clock = double_buffered(iter_prefetch(batches, depth=2), dispatch,
                               resolve, max_images=max_images)
    clock["images"] = n
    ood = None
    if unknown_scores and aucs:
        ood = {"AUROC": float(np.mean(aucs)), "FPR95": float(np.mean(fprs)),
               "AUPR": float(np.mean(auprs))}
        # the reference's printed order
        print(ood["AUROC"])
        print(ood["FPR95"])
        print(ood["AUPR"])
    return metrics.get_results(), ood, clock


def main(cfg, precision_dtype=torch.bfloat16, max_images=None, device=None):
    """Evaluate ``DEEPLAB.ckpt`` (or ``DIR/best.pkl``): a reference
    ``.pth`` or a JAX pickle. Returns ``(score, ood)``; ``score`` also
    holds ``images`` and ``seconds``, the loop's wall time."""
    d = cfg.DEEPLAB
    if d.save_val_results:
        raise NotImplementedError(
            "DEEPLAB.save_val_results needs utils/visualize.py, which is "
            "not ported yet; ROADMAP.md queues it")
    ckpt = d.ckpt or os.path.join(cfg.DIR, "best.pkl")
    if not os.path.exists(ckpt):
        raise FileNotFoundError(
            f"checkpoint {ckpt!r} not found: set DEEPLAB.ckpt")
    model, num_classes = build_deeplab_model(cfg, device)
    init_or_load_deeplab(model, ckpt)
    print(f"loaded checkpoint {ckpt}")
    _, val_tf = get_transforms(d.crop_size, d.dataset)
    val_ds = get_val_dataset(cfg, val_tf)

    metrics = StreamSegMetrics(num_classes)
    score, ood, clock = validate(
        model, val_ds, metrics, dtype=precision_dtype,
        batch_size=d.val_batch_size,
        unknown_scores="embedding" in d.model or d.unknown_scores,
        max_images=max_images)
    print(StreamSegMetrics.to_str(score))
    score.update(images=clock["images"], seconds=clock["total"])
    return score, ood


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--max-images", type=int, default=None,
                        help="evaluate only the first N images")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_images=args.max_images,
         device=args.device)


if __name__ == "__main__":
    _entry()
