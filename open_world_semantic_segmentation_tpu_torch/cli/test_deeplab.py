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
writes five PNGs per image into ``DIR/results`` (``save_val_result``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import (autocast, build_deeplab_model, double_buffered,
                           get_transforms, get_val_dataset,
                           init_or_load_deeplab)
from ..core.device import to_host_async
from ..data.loader import batch_iterator
from ..data.prefetch import iter_prefetch
from ..metrics.anom import get_measures
from ..metrics.segmentation import StreamSegMetrics
from ..utils.visualize import Denormalize


def save_val_result(image, target, pred, scores, decode_target, out_dir,
                    img_id: int):
    """Write the reference's five result PNGs of one image (main.py:209-234,
    test.py:258-283): ``<id>_image.png`` (the denormalised input),
    ``<id>_target.png`` and ``<id>_pred.png`` (colour-decoded),
    ``<id>_scores.png`` (255 * (1 - MSP)) and ``<id>_overlay.png`` (the
    prediction blended over the image at 0.7, what the reference's
    matplotlib ``imshow(alpha=.7)`` draws)."""
    os.makedirs(out_dir, exist_ok=True)
    img_u8 = (np.clip(Denormalize()(image), 0, 1) * 255).astype(np.uint8)
    target_rgb = np.asarray(decode_target(target)).astype(np.uint8)
    pred_rgb = np.asarray(decode_target(pred)).astype(np.uint8)
    scores_u8 = (255 * np.clip(scores, 0, 1)).astype(np.uint8)
    overlay = (0.3 * img_u8 + 0.7 * pred_rgb).astype(np.uint8)
    for kind, arr in (("image", img_u8), ("target", target_rgb),
                      ("pred", pred_rgb), ("scores", scores_u8),
                      ("overlay", overlay)):
        Image.fromarray(arr).save(os.path.join(out_dir,
                                               f"{img_id}_{kind}.png"))


def validate(model, val_ds, metrics: StreamSegMetrics, *, dtype,
             batch_size: int = 1, unknown_scores: bool = False,
             save_val_results: bool = False, results_dir: str = "results",
             max_images=None):
    """One pass over ``val_ds``; returns ``(score, ood or None, clock)``,
    ``clock`` as ``double_buffered`` returns it with ``images``. With
    ``save_val_results`` each image's five PNGs go to ``results_dir``,
    numbered from 0 in the order of the pass."""
    metrics.reset()
    dev = next(model.parameters()).device
    aucs, auprs, fprs = [], [], []
    img_id = 0

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
        return len(image), to_host_async([preds, 1.0 - msp]), batch

    def resolve(arrays, context):
        nonlocal img_id
        preds, scores = arrays
        image, target, target_true = context
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
        if save_val_results:
            for b in range(len(preds)):
                save_val_result(image[b], target[b], preds[b], scores[b],
                                val_ds.decode_target, results_dir, img_id)
                img_id += 1

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
        save_val_results=d.save_val_results,
        results_dir=os.path.join(cfg.DIR, "results"),
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
