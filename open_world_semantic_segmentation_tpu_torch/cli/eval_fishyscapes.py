"""Fishyscapes Lost&Found evaluation (the JAX package's
``cli/eval_fishyscapes.py``; the reference's test_eva.py).

The reference wraps its DeepLab model as an ``estimator(image) -> anomaly
map`` for the external ``bdlb`` harness. This driver runs the same
estimator over a local Lost&Found tree (an odgt list) and computes the
pooled-pixel AP / AUROC / FPR95 itself; ``--bdlb`` defers to the external
harness as the reference does (it raises where ``bdlb`` is absent).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.eval_fishyscapes \
      --cfg configs/cityscapes_embedding.yaml \
      DATASET.root_dataset /data/laf DATASET.list_val laf.odgt \
      [--method entropy|msp|dissum] [--max-images N]

Runs on CUDA unless ``--device cpu`` is given; the model is DEEPLAB.model,
seeded (DEEPLAB.random_seed) or from DEEPLAB.ckpt.
"""

from __future__ import annotations

import json

import torch

from ._common import compute_dtype, config_parser, parse_config
from .main_deeplab import build_deeplab_model, init_or_load_deeplab
from ..openset.fishyscapes import make_estimator, run_bdlb, run_native


def main(cfg, precision_dtype=torch.bfloat16, method: str = "entropy",
         max_images=None, use_bdlb: bool = False, device=None):
    """Return ``run_native``'s dict (or the harness's result)."""
    model, _ = build_deeplab_model(cfg, device)
    init_or_load_deeplab(model, cfg.DEEPLAB.ckpt,
                         seed=cfg.DEEPLAB.random_seed)
    estimator = make_estimator(model, method=method, dtype=precision_dtype)
    if use_bdlb:
        return run_bdlb(estimator)
    result = run_native(estimator, cfg.DATASET.root_dataset,
                        cfg.DATASET.list_val, max_images=max_images)
    print(json.dumps(result))
    return result


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--method", default="entropy",
                        choices=["entropy", "msp", "dissum"])
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--bdlb", action="store_true",
                        help="use the external bdlb harness instead of "
                             "the native pooled-pixel evaluation")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), method=args.method,
         max_images=args.max_images, use_bdlb=args.bdlb, device=args.device)


if __name__ == "__main__":
    _entry()
