"""NPM 16+1 evaluation on Cityscapes (the JAX package's
``cli/eval_embedding.py``; the reference's test_embedding.py --test_only).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.eval_embedding \
      FEWSHOT.prototype_file prototype_car_5_shot.json \
      MODEL.weights_encoder best.pth

Runs on CUDA unless ``--device cpu`` is given. Per image, on the device in
one pass: the embedding model's forward, the base head's argmax, the
distance of every pixel to the k-shot averaged prototype, the novel id
where that distance beats the threshold and the largest base logit, and
the ground truth's remap (car -> 16, the ids above it shift down); then on
the host the streaming 19-class confusion matrix. Image k is dispatched
before image k-1's confusion matrix is taken (``double_buffered``).

``FEWSHOT.calibrate_scores`` adds the GMM/ECDF score calibration
(``openset/calibration.py``, the reference's dormant design): a collection
pass over up to ``FEWSHOT.calib_images`` val images through the base head
(dis_sum = -sum of the logits, in float32) fits the per-class state
(``fit_calibration``); the eval then also brings each image's float32
softmax and dis_sum maps to the host, scores the calibrated certainty
against the unknown region (label 255) and reports its mean AUROC / AUPR /
FPR95 as ``calib_auroc``, ``calib_aupr``, ``calib_fpr95``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import (autocast, build_deeplab_model, double_buffered,
                           get_transforms, init_or_load_deeplab)
from ..core.device import to_host_async
from ..data.cityscapes import Cityscapes
from ..data.loader import batch_iterator
from ..data.prefetch import prefetch_to_device
from ..fewshot.prototypes import (load_prototypes, npm_label_remap,
                                  npm_override)
from ..metrics.anom import eval_ood_measure
from ..metrics.segmentation import StreamSegMetrics
from ..openset.calibration import ScoreCalibration, collect_dissum_samples


def fit_calibration(model, dataset, num_classes, cfg,
                    precision_dtype=torch.float32):
    """The collection and fit pass of the GMM/ECDF calibration (the
    reference's main_embedding.py:175-226 made live): up to
    ``FEWSHOT.calib_images`` images of ``dataset`` through the base head,
    per-class dis_sum samples drawn with ``np.random.default_rng(0)``, a
    GMM and an ECDF fitted per class. Where no pixel's prediction agrees
    with its label (untrained weights), the samples are taken where the
    label alone says the class, with a message, as the JAX package does.
    ``FEWSHOT.calib_save`` names an ``.npz`` for the fitted state."""
    dev = next(model.parameters()).device
    per_image = []
    for image, target, _ in batch_iterator(dataset, 1, shuffle=False,
                                           drop_last=False, epochs=1):
        with torch.inference_mode(), autocast(dev, precision_dtype):
            logits, _, _ = model(torch.from_numpy(image).to(dev))
        dissum = -logits[0].float().sum(-1)
        per_image.append((dissum.cpu().numpy(),
                          logits[0].argmax(-1).cpu().numpy(),
                          target[0] if target.ndim == 3 else target))
        if len(per_image) >= cfg.FEWSHOT.calib_images:
            break

    def collect(require_agreement):
        rng = np.random.default_rng(0)
        data_list = [[] for _ in range(num_classes + 1)]
        for dis, prd, lab in per_image:
            collect_dissum_samples(
                dis, prd if require_agreement else lab, lab,
                num_classes, data_list, rng, rate=cfg.FEWSHOT.calib_rate)
        return data_list

    try:
        calib = ScoreCalibration.fit(collect(True),
                                     mode=cfg.FEWSHOT.calib_mode)
    except ValueError:
        print("score calibration: no prediction/label agreement anywhere — "
              "falling back to ground-truth-conditioned collection")
        calib = ScoreCalibration.fit(collect(False),
                                     mode=cfg.FEWSHOT.calib_mode)
    if cfg.FEWSHOT.calib_save:
        calib.save(cfg.FEWSHOT.calib_save)
        print(f"calibration state saved to {cfg.FEWSHOT.calib_save}")
    return calib


def main(cfg, precision_dtype=torch.float32, max_images=None, device=None,
         split: str = "val", fused_blocks: bool = False):
    """Evaluate and return ``StreamSegMetrics``' results, with ``images``,
    ``seconds`` (the loop's wall time), its split per image
    (``device_s_per_img``: dispatch and waiting for the outputs;
    ``wait_s_per_img``: blocked on the loader; ``metric_s_per_img``: the
    host confusion matrix), and ``novel_pixels`` / ``pixels``: how many
    pixels the NPM override relabelled, of how many.

    ``fused_blocks`` (no CLI flag, as ``cli/eval_ood.main``): the
    backbone's eligible bottlenecks run through the fused kernel. With
    ``FEWSHOT.calibrate_scores`` the results also hold ``calib_auroc``,
    ``calib_aupr`` and ``calib_fpr95`` where an image held unknowns."""
    model, num_classes = build_deeplab_model(cfg, device,
                                             fused_blocks=fused_blocks)
    init_or_load_deeplab(
        model, cfg.MODEL.weights_encoder or cfg.MODEL.weights_decoder)
    dev = next(model.parameters()).device
    _, val_tf = get_transforms(cfg.DEEPLAB.crop_size)
    val_ds = Cityscapes(cfg.DATASET.root_dataset, split=split,
                        transform=val_tf,
                        unknown_target=tuple(cfg.DEEPLAB.unknown_target))

    prototype = torch.from_numpy(
        load_prototypes(cfg.FEWSHOT.prototype_file)).to(dev)
    novel_id = num_classes  # 16
    threshold = cfg.FEWSHOT.npm_dis_threshold
    calib = None
    if cfg.FEWSHOT.calibrate_scores:
        calib = fit_calibration(model, val_ds, num_classes, cfg,
                                precision_dtype)
    calib_measures = []
    metrics = StreamSegMetrics(num_classes + 1)
    metrics.reset()
    novel = torch.zeros((), dtype=torch.int64, device=dev)
    pixels = 0

    @torch.inference_mode()
    def dispatch(batch):
        nonlocal novel, pixels
        with autocast(dev, precision_dtype):
            logits, _, features = model(batch["image"])
        preds = logits.argmax(-1)
        new_preds, _ = npm_override(preds[0], features[0], logits[0],
                                    prototype, novel_id=novel_id,
                                    dis_threshold=threshold)
        remapped = npm_label_remap(batch["label"][0], novel_id=novel_id)
        novel = novel + (new_preds == novel_id).sum()
        pixels += new_preds.numel()
        # labels and predictions lie in 0..255: one byte each to the host
        host = [new_preds.to(torch.uint8), remapped.to(torch.uint8)]
        if calib is not None:
            # the calibration's inputs: float32 softmax and dis_sum, and
            # the label before the remap (unknowns 255)
            lg = logits[0].float()
            host += [torch.softmax(lg, -1), -lg.sum(-1),
                     batch["label"][0].to(torch.uint8)]
        return 1, to_host_async(host), None

    def resolve(arrays, _):
        preds, labels = arrays[:2]
        metrics.update(labels[None].astype(np.int64), preds[None])
        if calib is not None:
            probs, dissum, raw = arrays[2:]
            cert, _ = calib.apply(probs, dissum)
            res = eval_ood_measure(cert, raw, out_labels=(255,))
            if res is not None:
                calib_measures.append(res)

    batches = ({"image": image, "label": target.astype(np.int32)}
               for image, target, _ in batch_iterator(
                   val_ds, 1, shuffle=False, drop_last=False, epochs=1))
    # decode in a thread, pinned copies with two images in flight
    n, clock = double_buffered(prefetch_to_device(batches, dev), dispatch,
                               resolve, max_images=max_images)
    score = metrics.get_results()
    print(StreamSegMetrics.to_str(score))
    score.update(
        images=n, seconds=clock["total"],
        device_s_per_img=clock["device"] / max(n, 1),
        wait_s_per_img=clock["wait"] / max(n, 1),
        metric_s_per_img=clock["host"] / max(n, 1),
        novel_pixels=int(novel), pixels=pixels)
    if calib_measures:
        m = np.mean(np.asarray(calib_measures, np.float64), axis=0)
        print(f"calibrated-score OOD  auroc {m[0]:.4f}  aupr {m[1]:.4f}  "
              f"fpr95 {m[2]:.4f}  ({len(calib_measures)} images)")
        score.update(calib_auroc=float(m[0]), calib_aupr=float(m[1]),
                     calib_fpr95=float(m[2]))
    return score


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
