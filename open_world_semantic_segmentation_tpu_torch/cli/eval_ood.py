"""Open-set (OOD) evaluation (the reference's eval_ood_traditional.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.eval_ood \
      --cfg configs/test_ood_street.yaml OOD.ood knn

Runs on CUDA unless ``--device cpu`` is given. Prints per-class IoU, mean
IoU / accuracy / mean inference time, and the mean per-image AUROC / AUPR /
FPR95 in the reference's format.
"""

from __future__ import annotations

import time

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
from ..openset.evaluator import OODEvaluator


def main(cfg, precision_dtype=torch.float32, max_images=None,
         batch_images: int = 1, device=None, seed: int = 0):
    """Evaluate ``cfg`` and return the summary dict, with ``seconds``: the
    wall time of the eval loop (data, device work and host metrics)."""
    if cfg.VAL.visualize:
        raise NotImplementedError("VAL.visualize is not ported yet")
    model = build_anomaly_model(cfg, device)
    init_or_load_variables(cfg, model, seed=seed)

    pipeline = ValPipeline(
        cfg.DATASET.root_dataset, cfg.DATASET.list_val,
        img_sizes=cfg.DATASET.imgSizes,
        img_max_size=cfg.DATASET.imgMaxSize,
        padding_constant=cfg.DATASET.padding_constant,
        max_sample=max_images or -1)
    # background host decode/resample overlapped with device compute
    loader = iter_prefetch(pipeline, depth=2 * max(1, batch_images))

    evaluator = OODEvaluator(
        model,
        num_class=cfg.DATASET.num_class,
        method=cfg.OOD.ood,
        out_labels=cfg.OOD.out_labels,
        exclude_back=cfg.OOD.exclude_back,
        dtype=precision_dtype)
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
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_images=args.max_images,
         batch_images=args.batch_images, device=args.device)


if __name__ == "__main__":
    _entry()
