"""Open-set (OOD) evaluation (the reference's eval_ood_traditional.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.eval_ood \
      --cfg configs/test_ood_street.yaml OOD.ood knn

Runs on CUDA unless ``--device cpu`` is given. Prints per-class IoU, mean
IoU / accuracy / mean inference time, and the mean per-image AUROC / AUPR /
FPR95 in the reference's format. ``--device-metrics`` computes AUROC / AUPR
/ FPR95 on the device (``metrics/anom_device.py``); the host float64 sweep
is the default. ``VAL.visualize True`` writes each image's [image | gt |
pred] grid into ``DIR/result``. ``OOD.ood`` takes every method of
``openset/scoring.py SCORING_METHODS``, the CRFs (``crf``, ``crf-gauss``)
included. ``--quant`` runs the opt-in int8 PTQ eval (``ops/quant.py``):
``int8``, ``int8-hybrid`` (int8 backbone and PPM branches, the fuse conv
concat-free), ``int8-3x3`` or ``w4a8``, the activation scales calibrated on
the first ``calib_images`` val images before the eval.
"""

from __future__ import annotations

import os
import time

import torch

from ._common import (
    build_anomaly_model,
    calibrate_quant_model,
    compute_dtype,
    config_parser,
    init_or_load_variables,
    parse_config,
)
from ..data.odgt import ValPipeline
from ..data.prefetch import iter_prefetch
from ..openset.evaluator import OODEvaluator
from ..ops.quant import EVAL_QUANT_MODES


def main(cfg, precision_dtype=torch.float32, max_images=None,
         batch_images: int = 1, device=None, seed: int = 0,
         device_metrics: bool = False, fused_blocks: bool = False,
         device_pyramid: bool = False, quant: str = "off",
         calib_images: int = 4):
    """Evaluate ``cfg`` and return the summary dict, with ``seconds``: the
    wall time of the eval loop (data, device work and host metrics).

    ``device_metrics``: AUROC / AUPR / FPR95 on the device. Python keywords
    with no CLI flag, as in the JAX package: ``fused_blocks``, the
    backbone's eligible bottlenecks run through the fused kernel;
    ``device_pyramid``, the loader ships one uint8 image and the pyramid
    is normalised and resized on the device.

    ``quant``: an int8 PTQ mode, or "off" (the default). Its scales are
    calibrated on the smallest and the largest pyramid level of the first
    ``calib_images`` val images (the levels between share the per-tensor
    scales), each group of one input and label shape at once; then the
    weights are prequantized, except under ``w4a8``."""
    model = build_anomaly_model(cfg, device, fused_blocks=fused_blocks,
                                use_softmax=True, quant=quant)
    init_or_load_variables(cfg, model, seed=seed)
    if quant != "off":
        cal_pipe = ValPipeline(
            cfg.DATASET.root_dataset, cfg.DATASET.list_val,
            img_sizes=cfg.DATASET.imgSizes,
            img_max_size=cfg.DATASET.imgMaxSize,
            padding_constant=cfg.DATASET.padding_constant,
            max_sample=calib_images)
        groups = {}
        for item in cal_pipe:
            pyr = item["img_data"]
            seg = tuple(item["seg_label"].shape[1:3])
            for im in {id(pyr[0]): pyr[0], id(pyr[-1]): pyr[-1]}.values():
                groups.setdefault((im.shape, seg), []).append(im)
        calibrate_quant_model(
            cfg, model, [(imgs, seg) for (_, seg), imgs in groups.items()],
            quant=quant, dtype=precision_dtype, use_softmax=True)
        print(f"int8 calibration done on {calib_images} images")

    pipeline = ValPipeline(
        cfg.DATASET.root_dataset, cfg.DATASET.list_val,
        img_sizes=cfg.DATASET.imgSizes,
        img_max_size=cfg.DATASET.imgMaxSize,
        padding_constant=cfg.DATASET.padding_constant,
        max_sample=max_images or -1,
        device_pyramid=device_pyramid)
    # background host decode/resample overlapped with device compute
    loader = iter_prefetch(pipeline, depth=2 * max(1, batch_images))

    evaluator = OODEvaluator(
        model,
        num_class=cfg.DATASET.num_class,
        method=cfg.OOD.ood,
        out_labels=cfg.OOD.out_labels,
        exclude_back=cfg.OOD.exclude_back,
        dtype=precision_dtype,
        device_metrics=device_metrics,
        visualize_dir=(os.path.join(cfg.DIR, "result")
                       if cfg.VAL.visualize else None))
    tic = time.perf_counter()
    if batch_images > 1:
        result = evaluator.evaluate_batched(loader,
                                            batch_size=batch_images,
                                            progress=True)
    else:
        result = evaluator.evaluate(loader, progress=False)
    result["seconds"] = time.perf_counter() - tic
    print("Evaluation Done!")
    return result


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--batch-images", type=int, default=8,
                        help="images per forward (1 = per-image)")
    parser.add_argument("--max-images", type=int, default=None,
                        help="evaluate only the first N images")
    parser.add_argument("--device-metrics", action="store_true",
                        help="compute AUROC/AUPR/FPR on the device (the "
                             "host float64 sweep is the default)")
    parser.add_argument("--quant", choices=EVAL_QUANT_MODES, default="off",
                        help="opt-in int8 PTQ inference (ops/quant.py): "
                             "int8 activations and weights, or w4a8 (int4 "
                             "weights)")
    parser.add_argument("--calib-images", type=int, default=4,
                        help="val images the int8 scales are calibrated on")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_images=args.max_images,
         batch_images=args.batch_images, device=args.device,
         device_metrics=args.device_metrics, quant=args.quant,
         calib_images=args.calib_images)


if __name__ == "__main__":
    _entry()
