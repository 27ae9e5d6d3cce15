"""Reconstruction-based OOD evaluation (the JAX package's
``cli/eval_ood_rec.py``; the reference's anomaly/eval_ood_rec.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.eval_ood_rec \
      --cfg configs/test_ood_rec.yaml

Runs on CUDA unless ``--device cpu`` is given. Two aligned pipelines: the
original test images and their reconstructions (``DATASET.rec_dataset``,
matched by folder and name). Per image, on the device:

- each scale's ppm_deepsup forward at label size, for both images;
- the per-scale PPM-concat features (``ft``, 4096-d) are resized to
  (H/4, W/4) and averaged there (each divided by n, then summed);
- the cosine of the two averaged maps at that size, upsampled to (H, W);
- "msp" is the max of the averaged raw logits at full size (ppm_deepsup
  applies no softmax at inference; the reference takes no second one),
  ``conf = msp*(msp>0.999) + cos*(msp<=0.999)`` at full size.

Then on the host the per-image AUROC / AUPR / FPR95 (float64 sweep), and
per-class IoU and accuracy in the reference's format.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ._common import (
    build_anomaly_model,
    compute_dtype,
    config_parser,
    init_or_load_variables,
    parse_config,
)
from ..data.odgt import ValPipeline
from ..data.prefetch import iter_prefetch
from ..metrics.anom import eval_ood_measure
from ..metrics.meters import AverageMeter
from ..metrics.segmentation import intersection_and_union_torch
from ..openset.scoring import rec_cosine_conf, rec_cosine_map
from ..ops.resize import bilinear_resize


def rec_combine(scores_list, ft_o_list, ft_r_list, seg_size,
                exclude_back: bool = False):
    """Everything after the per-scale forwards (NHWC).

    ``scores_list``: per-scale scores at ``seg_size``, each (1, H, W, K);
    ``ft_*_list``: per-scale PPM-concat features at their conv5
    resolutions, each (1, h, w, C). Returns (conf, pred) at ``seg_size``.
    """
    n = len(scores_list)
    ft_size = (seg_size[0] // 4, seg_size[1] // 4)
    scores = sum(s / n for s in scores_list)[0]
    ft_o = sum(bilinear_resize(f, ft_size) / n for f in ft_o_list)[0]
    ft_r = sum(bilinear_resize(f, ft_size) / n for f in ft_r_list)[0]
    tmp = scores[..., 1:] if exclude_back else scores
    msp = tmp.amax(dim=-1)
    cos = rec_cosine_map(ft_o, ft_r)
    cos = bilinear_resize(cos[None, :, :, None], seg_size)[0, :, :, 0]
    conf = rec_cosine_conf(msp, cos)
    pred = scores.argmax(dim=-1)
    return conf, pred


def main(cfg, precision_dtype=torch.float32, max_images=None, device=None):
    """Evaluate and return ``auroc``, ``aupr``, ``fpr`` (None where no image
    holds both in- and out-pixels), ``mean_iou``, ``accuracy``, ``images``,
    ``inference_time`` (device s/img) and ``seconds``, the loop's wall
    time."""
    model = build_anomaly_model(cfg, device, use_softmax=True)
    init_or_load_variables(cfg, model)
    dev = next(model.parameters()).device
    common = dict(img_sizes=cfg.DATASET.imgSizes,
                  img_max_size=cfg.DATASET.imgMaxSize,
                  padding_constant=cfg.DATASET.padding_constant,
                  max_sample=max_images or -1)
    orig = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                       **common)
    rec = ValPipeline(cfg.DATASET.root_dataset, cfg.DATASET.list_val,
                      rec_dataset=cfg.DATASET.rec_dataset, **common)
    exclude_back = bool(cfg.OOD.exclude_back)
    num_class = cfg.DATASET.num_class

    @torch.inference_mode()
    def forward(item_o, item_r, seg):
        seg_size = tuple(seg.shape)
        outs = {}
        with torch.autocast(dev.type, dtype=precision_dtype,
                            enabled=precision_dtype != torch.float32):
            for key, item in (("o", item_o), ("r", item_r)):
                outs[key] = [model(torch.from_numpy(x).to(dev),
                                   seg_size=seg_size, want_ft=True)
                             for x in item["img_data"]]
        conf, pred = rec_combine([o["scores"] for o in outs["o"]],
                                 [o["ft"] for o in outs["o"]],
                                 [o["ft"] for o in outs["r"]],
                                 seg_size, exclude_back)
        valid = seg >= 0
        counts = torch.stack([(valid & (pred == seg)).sum(), valid.sum()])
        inter, union = intersection_and_union_torch(pred, seg, num_class)
        return [t.cpu().numpy() for t in (conf.float(), counts, inter,
                                          union)]

    aurocs, auprs, fprs = [], [], []
    time_meter = AverageMeter()
    acc_meter = AverageMeter()
    intersection_meter = AverageMeter()
    union_meter = AverageMeter()
    start = time.perf_counter()
    for item_o, item_r in iter_prefetch(zip(orig, rec), depth=2):
        seg_np = item_o["seg_label"][0]
        tic = time.perf_counter()
        conf, counts, inter, union = forward(
            item_o, item_r, torch.from_numpy(seg_np).to(dev).long())
        time_meter.update(time.perf_counter() - tic)
        res = eval_ood_measure(conf, seg_np, out_labels=cfg.OOD.out_labels)
        if res is not None:
            aurocs.append(res[0])
            auprs.append(res[1])
            fprs.append(res[2])
        acc = float(counts[0]) / (float(counts[1]) + 1e-10)
        acc_meter.update(acc, int(counts[1]))
        intersection_meter.update(inter)
        union_meter.update(union)
    seconds = time.perf_counter() - start

    iou = intersection_meter.sum / (union_meter.sum + 1e-10)
    for i, v in enumerate(iou):
        print("class [{}], IoU: {:.4f}".format(i, v))
    print("[Eval Summary]:")
    print("Mean IoU: {:.4f}, Accuracy: {:.2f}%, Inference Time: {:.4f}s"
          .format(float(iou.mean()), acc_meter.average() * 100,
                  time_meter.average()))
    if aurocs:
        print("mean auroc = ", np.mean(aurocs), "mean aupr = ",
              np.mean(auprs), " mean fpr = ", np.mean(fprs))
    else:  # no image had both in- and out-pixels: nothing to average
        print("mean auroc =  n/a (no image with anomaly pixels)")
    return {"auroc": float(np.mean(aurocs)) if aurocs else None,
            "aupr": float(np.mean(auprs)) if auprs else None,
            "fpr": float(np.mean(fprs)) if fprs else None,
            "mean_iou": float(iou.mean()),
            "accuracy": float(acc_meter.average()),
            "images": int(time_meter.count),
            "inference_time": float(time_meter.average()),
            "seconds": seconds}


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
