#!/usr/bin/env python
"""Int8 PTQ drift of the port's StreetHazards eval on trained weights, on
the card and on the host's CPU.

``drift`` scores dissum with ``cli/eval_ood.main`` on ``cfg``'s tree and
weights without quant and in each given mode (calibrated as the eval
calibrates, on the smallest and largest pyramid level of the first
``calib_images`` val images), in float32 with TF32 off; each mode's
metrics carry their difference from the float run's.

The command trains the golden run's flagship recipe (``GOLDEN``, the one
``chip_smoke.py`` trains, through ``tools/golden_run.py run``) on the
first of ``--devices``, unless ``--tree`` and ``--weights`` name a
StreetHazards-format tree and a trained ``.pth`` pair; then it scores the
drift on every device in ``--devices`` with the same weights, and prints
as its last line one JSON object: ``runs`` (per device, per mode) and,
for two devices, ``difference``, the first's metrics minus the second's.

Usage:
    python -m open_world_semantic_segmentation_tpu_torch.tools.quant_drift \\
        [--modes w4a8] [--devices cuda cpu]
    ... --tree DIR --weights ENC.pth DEC.pth --encoder resnet18dilated \\
        --img-sizes 64 72 80 88 96 --max-size 240
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..cli import eval_ood
from ..core.config import default_config
from ..ops.quant import EVAL_QUANT_MODES
from .golden_run import exact_fp32, run as golden_run

METRICS = ("auroc", "aupr", "fpr", "mean_iou", "accuracy")
# the golden StreetHazards recipe chip_smoke.py trains
GOLDEN = dict(steps=2000, lr=0.05, img_size=128, noise=10.0, n_val=13,
              n_train=64, n_blobs=5, min_block=40)
# chip_smoke.py's quant eval: a 5-scale pyramid around the golden images'
# 128-pixel training scale, 4 calibration images
PYRAMID = (96, 112, 128, 144, 160)
MAX_SIZE = 400
CALIB_IMAGES = 4


def eval_cfg(tree, weights, encoder="resnet50dilated",
             decoder="ppm_deepsup_embedding", img_sizes=PYRAMID,
             max_size=MAX_SIZE):
    """The dissum eval of ``weights`` (encoder, decoder ``.pth``) on the
    val split of the StreetHazards-format ``tree``."""
    cfg = default_config()
    cfg.DATASET.root_dataset = tree
    cfg.DATASET.list_val = os.path.join(tree, "val.odgt")
    cfg.DATASET.num_class = 13
    cfg.DATASET.imgSizes = tuple(img_sizes)
    cfg.DATASET.imgMaxSize = max_size
    cfg.MODEL.arch_encoder = encoder
    cfg.MODEL.arch_decoder = decoder
    cfg.MODEL.weights_encoder, cfg.MODEL.weights_decoder = weights
    cfg.OOD.ood = "dissum"
    return cfg


def drift(cfg, device, modes=EVAL_QUANT_MODES,
          calib_images=CALIB_IMAGES):
    """``{mode: metrics}`` for "off" and each of ``modes`` on ``device``;
    a quantized mode's entry has ``drift``, its metrics minus the float
    run's, and each has ``imgs_per_s``."""
    runs = {}
    for mode in ("off",) + tuple(m for m in modes if m != "off"):
        with exact_fp32():
            r = eval_ood.main(cfg, torch.float32, device=device, quant=mode,
                              calib_images=calib_images)
        run = {k: r[k] for k in METRICS}
        run["imgs_per_s"] = r["images"] / r["seconds"]
        if mode != "off":
            run["drift"] = {k: run[k] - runs["off"][k] for k in METRICS}
        runs[mode] = run
        print(f"[quant-drift] {device} {mode}: {json.dumps(run)}",
              flush=True)
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="StreetHazards-format tree (val.odgt); "
                    "without it the golden recipe is trained first")
    ap.add_argument("--weights", nargs=2, metavar=("ENC", "DEC"))
    ap.add_argument("--encoder", default="resnet50dilated")
    ap.add_argument("--img-sizes", type=int, nargs="+", default=PYRAMID)
    ap.add_argument("--max-size", type=int, default=MAX_SIZE)
    ap.add_argument("--modes", nargs="+", default=["w4a8"],
                    choices=EVAL_QUANT_MODES[1:])
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--calib-images", type=int, default=CALIB_IMAGES)
    args = ap.parse_args(argv)
    if (args.tree is None) != (args.weights is None):
        ap.error("--tree and --weights go together")
    with tempfile.TemporaryDirectory(prefix="owss_quant_drift_") as work:
        tree, weights = args.tree, args.weights
        if tree is None:
            golden_run(encoder=args.encoder, methods=("dissum",),
                       workdir=work, device=args.devices[0], **GOLDEN)
            tree = os.path.join(work, "sh")
            weights = [os.path.join(work, "ckpt", f"{part}_epoch_1.pth")
                       for part in ("encoder", "decoder")]
        cfg = eval_cfg(tree, weights, encoder=args.encoder,
                       img_sizes=args.img_sizes, max_size=args.max_size)
        cfg.DIR = os.path.join(work, "eval")
        runs = {d: drift(cfg, d, args.modes, args.calib_images)
                for d in args.devices}
    out = {"runs": runs}
    if len(args.devices) == 2:
        a, b = (runs[d] for d in args.devices)
        out["difference"] = {m: {k: a[m][k] - b[m][k] for k in METRICS}
                             for m in a}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
