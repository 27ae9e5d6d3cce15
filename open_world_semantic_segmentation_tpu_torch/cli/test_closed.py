"""Closed-set multi-scale evaluation with prediction PNGs (the JAX
package's ``cli/test_closed.py``; the reference's anomaly/test.py).

Usage:
  python -m open_world_semantic_segmentation_tpu_torch.cli.test_closed \
      --cfg configs/test_test.yaml TEST.result ./out

Runs on CUDA unless ``--device cpu`` is given. Per image: the multi-scale
averaged forward (``configs/test_test.yaml``: resnet50dilated +
ppm_deepsup), the argmax prediction, per-class IoU and the MSP map's
AUROC / AUPR / FPR95; with ``TEST.result`` set, ``pred + 1`` is written as
an L-mode PNG under ``TEST.result/<folder>/<name>``, as the reference
does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from PIL import Image

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


def main(cfg, precision_dtype=torch.float32, max_images=None, device=None):
    """Evaluate and return the evaluator's summary, with ``seconds``: the
    loop's wall time, PNG writing included."""
    model = build_anomaly_model(cfg, device, use_softmax=True)
    init_or_load_variables(cfg, model)
    pipeline = ValPipeline(
        cfg.DATASET.root_dataset, cfg.DATASET.list_val,
        img_sizes=cfg.DATASET.imgSizes,
        img_max_size=cfg.DATASET.imgMaxSize,
        padding_constant=cfg.DATASET.padding_constant,
        max_sample=max_images or -1)
    evaluator = OODEvaluator(model, num_class=cfg.DATASET.num_class,
                             method="msp", out_labels=cfg.OOD.out_labels,
                             dtype=precision_dtype)
    result_dir = cfg.TEST.result
    tic = time.perf_counter()
    for item in iter_prefetch(pipeline, depth=2):
        out = evaluator.evaluate_item(item)
        if result_dir:
            # the reference saves pred + 1 as an L png per source folder
            pred_png = (out["pred"] + 1).astype(np.uint8)
            dst = os.path.join(result_dir, item["name"])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            Image.fromarray(pred_png, "L").save(dst)
    seconds = time.perf_counter() - tic
    result = evaluator.summary()
    result["seconds"] = seconds
    return result


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
